// K2 closest sweep, K3 occlusion sweep and K3b occlusion sweep with
// blocker hints, over the per-tile cluster schedule.
//
// Replaces pathtracer/kernels/pallas_sweep.py:_sweep_kernel (through
// sweep_closest) and :_occl_kernel (through sweep_occluded, K3 without and
// K3b with want_blocker), with the dense Baldwin-Weber lane test of
// _bw_lane.
//
// Layout: one block per tile, one thread per ray (R = 64 threads). The
// block walks its tile's near-to-far schedule st/si [tiles, Cs] one
// cluster at a time: the cluster's [16, K] Baldwin-Weber rows (8 KB at
// K = 128) are staged in shared memory by a cooperative coalesced load,
// then each thread tests its ray against the K triangles in lane order.
//
// K2 keeps the nearest (t, tri, u, v) per ray, seeded from the scene-exit
// cap t_cap. A lane replaces the current best only with a strictly smaller
// t, which reproduces "first minimum wins" inside a cluster and "earlier
// column wins on ties" across clusters. The tile stops when the next entry
// st[j] is not below the block maximum of best_t (a block reduction).
// K3 keeps a per-thread blocked flag (front-facing hit, 0 < t < t_max) and
// stops when __syncthreads_count(!blocked) == 0 or st[j] == +inf.
// K3b is the same loop (one template) that also records a blocker id: in
// the first cluster of the schedule where a ray becomes blocked it scans
// every lane instead of stopping at the first hit, keeps the blocking lane
// with the smallest t (the lowest lane on a tie, the argmin of
// pallas_sweep.py:294-307) and writes that lane's triangle id; -1 where
// the ray stays open. Only the newly blocked cluster pays the full scan,
// so K3b costs about what K3 costs.
//
// Built with -fmad=false: every expression below is a rounded product and
// a rounded sum in the order the plain PyTorch versions use, so the kernel
// and its plain version agree hit for hit and bit for bit.
//
// What bounds it on an H100: FP32 ALU for the ~40 operations per
// (ray, triangle) pair, plus the per-column fixed cost (a block reduction,
// two barriers, an 8 KB load from L2 - the ~2.8k-cluster table of the
// headline scene is ~23 MB and stays resident in the 50 MB L2). A 64-thread
// block keeps the barrier cheap and lets up to 32 blocks share an SM. The
// TPU version's DMA ring, cpi-granular stops and lane padding are not
// carried over; the stop granule does not change the hits.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kDetEps = 1e-12f;

// Max of v over the block (blockDim.x a multiple of 32, at most 1024).
__device__ float block_max(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // previous readers of red are done
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) m = fmaxf(m, red[w]);
  return m;
}

__device__ void load_cluster(float* blk, const float* __restrict__ blocks,
                             int cid, int k) {
  const float* src = blocks + (size_t)cid * 16 * k;
  for (int i = threadIdx.x; i < 16 * k; i += blockDim.x) blk[i] = src[i];
}

// One Baldwin-Weber lane test (pallas_sweep.py:_bw_lane); returns whether
// the ray hits triangle lane l with t_min < t < t_hi, and t/u/v/denom.
__device__ bool bw_lane(const float* blk, int k, int l, float ox, float oy,
                        float oz, float dx, float dy, float dz, float t_min,
                        float t_hi, float& t, float& u, float& v,
                        float& denom) {
  const float nx = blk[l], ny = blk[k + l], nz = blk[2 * k + l];
  const float dpl = blk[3 * k + l];
  const float r1x = blk[4 * k + l], r1y = blk[5 * k + l],
              r1z = blk[6 * k + l], c1 = blk[7 * k + l];
  const float r2x = blk[8 * k + l], r2y = blk[9 * k + l],
              r2z = blk[10 * k + l], c2 = blk[11 * k + l];
  denom = dx * nx + dy * ny + dz * nz;
  const bool ok_det = fabsf(denom) > kDetEps;
  const float inv = ok_det ? 1.0f / denom : 0.0f;
  t = (dpl - (ox * nx + oy * ny + oz * nz)) * inv;
  const float hx = ox + t * dx;
  const float hy = oy + t * dy;
  const float hz = oz + t * dz;
  u = r1x * hx + r1y * hy + r1z * hz + c1;
  v = r2x * hx + r2y * hy + r2z * hz + c2;
  return ok_det && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > t_min &&
         t < t_hi;
}

__global__ void sweep_closest_kernel(const float* __restrict__ st,
                                     const int* __restrict__ si, int cs,
                                     const float* __restrict__ rays,
                                     const float* __restrict__ t_cap,
                                     const float* __restrict__ blocks, int k,
                                     float t_min, float* __restrict__ out_t,
                                     int* __restrict__ out_tri,
                                     float* __restrict__ out_u,
                                     float* __restrict__ out_v) {
  extern __shared__ float sh[];  // blk[16 * k], red[32]
  float* blk = sh;
  float* red = sh + 16 * k;
  const size_t tile = blockIdx.x;
  const int r = threadIdx.x, nr = blockDim.x;
  const float* ray = rays + tile * 6 * nr;
  const float ox = ray[r], oy = ray[nr + r], oz = ray[2 * nr + r];
  const float dx = ray[3 * nr + r], dy = ray[4 * nr + r],
              dz = ray[5 * nr + r];
  float best_t = t_cap[tile * nr + r];
  int best_tri = -1;
  float best_u = 0.0f, best_v = 0.0f;
  const float* st_t = st + tile * cs;
  const int* si_t = si + tile * cs;
  for (int j = 0; j < cs; ++j) {
    const float tile_max = block_max(best_t, red);  // barrier inside
    if (!(st_t[j] < tile_max)) break;               // uniform in the block
    load_cluster(blk, blocks, si_t[j], k);
    __syncthreads();
    for (int l = 0; l < k; ++l) {
      float t, u, v, denom;
      if (bw_lane(blk, k, l, ox, oy, oz, dx, dy, dz, t_min, best_t, t, u, v,
                  denom)) {
        const int id = (int)rintf(blk[12 * k + l]) - 1;
        if (id >= 0) {
          best_t = t;
          best_tri = id;
          best_u = u;
          best_v = v;
        }
      }
    }
  }
  out_t[tile * nr + r] = best_t;
  out_tri[tile * nr + r] = best_tri;
  out_u[tile * nr + r] = best_u;
  out_v[tile * nr + r] = best_v;
}

template <bool kBlocker>
__global__ void sweep_occluded_kernel(const float* __restrict__ st,
                                      const int* __restrict__ si, int cs,
                                      const float* __restrict__ rays,
                                      const float* __restrict__ t_max,
                                      const float* __restrict__ blocks, int k,
                                      int* __restrict__ out_blocked,
                                      int* __restrict__ out_btri) {
  extern __shared__ float sh[];  // blk[16 * k]
  const size_t tile = blockIdx.x;
  const int r = threadIdx.x, nr = blockDim.x;
  const float* ray = rays + tile * 6 * nr;
  const float ox = ray[r], oy = ray[nr + r], oz = ray[2 * nr + r];
  const float dx = ray[3 * nr + r], dy = ray[4 * nr + r],
              dz = ray[5 * nr + r];
  const float tm = t_max[tile * nr + r];
  const float* st_t = st + tile * cs;
  const int* si_t = si + tile * cs;
  int blocked = 0;
  int btri = -1;
  for (int j = 0; j < cs; ++j) {
    // barrier: every thread finished the previous cluster before the load
    if (__syncthreads_count(!blocked) == 0) break;
    if (!(st_t[j] < INFINITY)) break;  // uniform in the block
    load_cluster(sh, blocks, si_t[j], k);
    __syncthreads();
    if (blocked) continue;
    int best_l = -1;
    float best_t = INFINITY;
    for (int l = 0; l < k; ++l) {
      float t, u, v, denom;
      if (bw_lane(sh, k, l, ox, oy, oz, dx, dy, dz, 0.0f, INFINITY, t, u, v,
                  denom) &&
          denom < 0.0f && t < tm) {
        if (!kBlocker) {
          blocked = 1;
          break;
        }
        if (t < best_t) {  // strict: the lowest lane wins a tie
          best_t = t;
          best_l = l;
        }
      }
    }
    if (kBlocker && best_l >= 0) {
      blocked = 1;
      btri = (int)rintf(sh[12 * k + best_l]) - 1;
    }
  }
  out_blocked[tile * nr + r] = blocked;
  if (kBlocker) out_btri[tile * nr + r] = btri;
}

}  // namespace

extern "C" int pt_sweep_closest(const float* st, const int* si, int tiles,
                                int cs, const float* rays, const float* t_cap,
                                const float* blocks, int k, int tile_rays,
                                float t_min, float* out_t, int* out_tri,
                                float* out_u, float* out_v, void* stream) {
  const size_t shmem = sizeof(float) * (16 * k + 32);
  sweep_closest_kernel<<<tiles, tile_rays, shmem, (cudaStream_t)stream>>>(
      st, si, cs, rays, t_cap, blocks, k, t_min, out_t, out_tri, out_u,
      out_v);
  return (int)cudaGetLastError();
}

extern "C" int pt_sweep_occluded(const float* st, const int* si, int tiles,
                                 int cs, const float* rays,
                                 const float* t_max, const float* blocks,
                                 int k, int tile_rays, int* out_blocked,
                                 void* stream) {
  const size_t shmem = sizeof(float) * 16 * k;
  sweep_occluded_kernel<false>
      <<<tiles, tile_rays, shmem, (cudaStream_t)stream>>>(
          st, si, cs, rays, t_max, blocks, k, out_blocked, nullptr);
  return (int)cudaGetLastError();
}

extern "C" int pt_sweep_occluded_blocker(const float* st, const int* si,
                                         int tiles, int cs, const float* rays,
                                         const float* t_max,
                                         const float* blocks, int k,
                                         int tile_rays, int* out_blocked,
                                         int* out_btri, void* stream) {
  const size_t shmem = sizeof(float) * 16 * k;
  sweep_occluded_kernel<true>
      <<<tiles, tile_rays, shmem, (cudaStream_t)stream>>>(
          st, si, cs, rays, t_max, blocks, k, out_blocked, out_btri);
  return (int)cudaGetLastError();
}
