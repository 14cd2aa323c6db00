// K1 tile cull: per-tile nearest cluster-entry distance.
//
// Replaces pathtracer/kernels/pallas_cull.py:_cull_kernel (called through
// tile_cull -> _tile_cull_impl). For each tile of R rays and each cluster
// AABB it runs the slab test with the precomputed 1/d and writes
//   out[tile, c] = min over the tile's rays of max(tn, 0)
// over the rays that pass (tn <= tf) & (tf >= t_min) & (tn <= t_max),
// +inf where none passes - the accept test and clamp of
// pallas_cull.py:48-63 exactly. The arithmetic is sub, mul, min and max
// only, so the result equals the plain PyTorch version bit for bit.
//
// What bounds it on an H100: ALU. Each (ray, cluster) pair costs ~20 FP32
// operations and reads nothing from device memory: the tile's rays sit in
// shared memory (broadcast reads, every thread of the block reads the same
// ray at once) and each thread holds its cluster's box in registers. The
// only device-memory traffic is the [tiles, C] output row per tile, written
// coalesced. Grid = (tiles, ceil(C / 256)), one thread per cluster.
// The TPU version kept the whole [6, C] AABB table resident in VMEM and
// reduced a dense [R, C] slab; here the ray loop runs inside each thread.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__global__ void tile_cull_kernel(const float* __restrict__ lo,
                                 const float* __restrict__ hi,
                                 const float* __restrict__ o,
                                 const float* __restrict__ inv_d,
                                 const float* __restrict__ t_max,
                                 float t_min, int n_clusters, int tile_rays,
                                 float* __restrict__ out) {
  extern __shared__ float sh[];  // [7][tile_rays]: o(3), inv_d(3), t_max
  const size_t tile = blockIdx.x;
  for (int i = threadIdx.x; i < tile_rays; i += blockDim.x) {
    const size_t r = tile * tile_rays + i;
    sh[i] = o[r * 3 + 0];
    sh[tile_rays + i] = o[r * 3 + 1];
    sh[2 * tile_rays + i] = o[r * 3 + 2];
    sh[3 * tile_rays + i] = inv_d[r * 3 + 0];
    sh[4 * tile_rays + i] = inv_d[r * 3 + 1];
    sh[5 * tile_rays + i] = inv_d[r * 3 + 2];
    sh[6 * tile_rays + i] = t_max[r];
  }
  __syncthreads();
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= n_clusters) return;
  const float lx = lo[c * 3 + 0], ly = lo[c * 3 + 1], lz = lo[c * 3 + 2];
  const float hx = hi[c * 3 + 0], hy = hi[c * 3 + 1], hz = hi[c * 3 + 2];
  float best = INFINITY;
  for (int i = 0; i < tile_rays; ++i) {
    const float ox = sh[i], oy = sh[tile_rays + i], oz = sh[2 * tile_rays + i];
    const float ix = sh[3 * tile_rays + i], iy = sh[4 * tile_rays + i],
                iz = sh[5 * tile_rays + i];
    float t1 = (lx - ox) * ix, t2 = (hx - ox) * ix;
    float tn = fminf(t1, t2), tf = fmaxf(t1, t2);
    t1 = (ly - oy) * iy;
    t2 = (hy - oy) * iy;
    tn = fmaxf(tn, fminf(t1, t2));
    tf = fminf(tf, fmaxf(t1, t2));
    t1 = (lz - oz) * iz;
    t2 = (hz - oz) * iz;
    tn = fmaxf(tn, fminf(t1, t2));
    tf = fminf(tf, fmaxf(t1, t2));
    const bool hit = (tn <= tf) && (tf >= t_min) && (tn <= sh[6 * tile_rays + i]);
    best = fminf(best, hit ? fmaxf(tn, 0.0f) : INFINITY);
  }
  out[tile * n_clusters + c] = best;
}

}  // namespace

extern "C" int pt_tile_cull(const float* aabb_lo, const float* aabb_hi,
                            const float* o, const float* inv_d,
                            const float* t_max, float t_min, int n_tiles,
                            int n_clusters, int tile_rays, float* out,
                            void* stream) {
  const dim3 grid(n_tiles, (n_clusters + kThreads - 1) / kThreads);
  const size_t shmem = sizeof(float) * 7 * tile_rays;
  tile_cull_kernel<<<grid, kThreads, shmem, (cudaStream_t)stream>>>(
      aabb_lo, aabb_hi, o, inv_d, t_max, t_min, n_clusters, tile_rays, out);
  return (int)cudaGetLastError();
}
