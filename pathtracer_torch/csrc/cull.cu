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

// K4 block-gated tile cull: the same out[tiles, C] as K1, bit for bit.
//
// Replaces pathtracer/kernels/pallas_cull.py:_cull_kernel_skip (with its
// supercluster mask _sc_mask). The clusters fall into blocks of `blk`
// consecutive ids; ub_lo/ub_hi [NB, 3] hold each block's union box (two
// torch reductions in the wrapper, over the clusters padded to a multiple
// of 128 with 1e30 boxes, as pallas_cull.py:183-189 and :120-121). One
// CUDA block per (tile, cluster block): threads < tile_rays run K1's slab
// test against the union box, and __syncthreads_or gives the block's
// flag. A block whose union box misses every ray of the tile writes +inf
// for its clusters without the slab test; a kept block runs K1's
// per-cluster ray loop. Exact by construction: a child box lies inside
// its union box and correctly rounded sub/mul/min/max are monotone, so
// each child's tn is >= the union's and its tf <= the union's, and a
// child of a gated block fails K1's accept test too.
//
// What bounds it on an H100: ALU, like K1 - NB union tests plus the kept
// blocks' (ray, cluster) pairs per tile, instead of every pair. The gate
// costs one block-wide barrier-reduction per (tile, block); with blk =
// 128 threads the kept block's loop is K1's one thread per cluster.
// mask_out (i32[tiles, NB], may be null) receives the flags so a test can
// hold them against the plain mask.
__global__ void tile_cull_skip_kernel(const float* __restrict__ lo,
                                      const float* __restrict__ hi,
                                      const float* __restrict__ ub_lo,
                                      const float* __restrict__ ub_hi,
                                      const float* __restrict__ o,
                                      const float* __restrict__ inv_d,
                                      const float* __restrict__ t_max,
                                      float t_min, int n_clusters,
                                      int tile_rays, int blk, int nb,
                                      float* __restrict__ out,
                                      int* __restrict__ mask_out) {
  extern __shared__ float sh[];  // [7][tile_rays]: o(3), inv_d(3), t_max
  const size_t tile = blockIdx.x;
  const int b = blockIdx.y;
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
  // the union box against this thread's rays, K1's exact sequence
  const float ulx = ub_lo[b * 3 + 0], uly = ub_lo[b * 3 + 1],
              ulz = ub_lo[b * 3 + 2];
  const float uhx = ub_hi[b * 3 + 0], uhy = ub_hi[b * 3 + 1],
              uhz = ub_hi[b * 3 + 2];
  int any = 0;
  for (int i = threadIdx.x; i < tile_rays; i += blockDim.x) {
    const float ox = sh[i], oy = sh[tile_rays + i], oz = sh[2 * tile_rays + i];
    const float ix = sh[3 * tile_rays + i], iy = sh[4 * tile_rays + i],
                iz = sh[5 * tile_rays + i];
    float t1 = (ulx - ox) * ix, t2 = (uhx - ox) * ix;
    float tn = fminf(t1, t2), tf = fmaxf(t1, t2);
    t1 = (uly - oy) * iy;
    t2 = (uhy - oy) * iy;
    tn = fmaxf(tn, fminf(t1, t2));
    tf = fminf(tf, fmaxf(t1, t2));
    t1 = (ulz - oz) * iz;
    t2 = (uhz - oz) * iz;
    tn = fmaxf(tn, fminf(t1, t2));
    tf = fminf(tf, fmaxf(t1, t2));
    any |= (tn <= tf) && (tf >= t_min) && (tn <= sh[6 * tile_rays + i]);
  }
  const int keep = __syncthreads_or(any);
  if (mask_out != nullptr && threadIdx.x == 0) mask_out[tile * nb + b] = keep;
  const int c_end = min((b + 1) * blk, n_clusters);
  float* row = out + tile * n_clusters;
  if (!keep) {
    for (int c = b * blk + threadIdx.x; c < c_end; c += blockDim.x)
      row[c] = INFINITY;
    return;
  }
  for (int c = b * blk + threadIdx.x; c < c_end; c += blockDim.x) {
    const float lx = lo[c * 3 + 0], ly = lo[c * 3 + 1], lz = lo[c * 3 + 2];
    const float hx = hi[c * 3 + 0], hy = hi[c * 3 + 1], hz = hi[c * 3 + 2];
    float best = INFINITY;
    for (int i = 0; i < tile_rays; ++i) {
      const float ox = sh[i], oy = sh[tile_rays + i],
                  oz = sh[2 * tile_rays + i];
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
      const bool hit =
          (tn <= tf) && (tf >= t_min) && (tn <= sh[6 * tile_rays + i]);
      best = fminf(best, hit ? fmaxf(tn, 0.0f) : INFINITY);
    }
    row[c] = best;
  }
}

constexpr int kSkipThreads = 128;

}  // namespace

extern "C" int pt_tile_cull_skip(const float* aabb_lo, const float* aabb_hi,
                                 const float* ub_lo, const float* ub_hi,
                                 const float* o, const float* inv_d,
                                 const float* t_max, float t_min, int n_tiles,
                                 int n_clusters, int tile_rays, int blk,
                                 int nb, float* out, int* mask_out,
                                 void* stream) {
  const dim3 grid(n_tiles, nb);
  const size_t shmem = sizeof(float) * 7 * tile_rays;
  tile_cull_skip_kernel<<<grid, kSkipThreads, shmem, (cudaStream_t)stream>>>(
      aabb_lo, aabb_hi, ub_lo, ub_hi, o, inv_d, t_max, t_min, n_clusters,
      tile_rays, blk, nb, out, mask_out);
  return (int)cudaGetLastError();
}

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
