// K1 tile cull and K4 block-gated tile cull: per-tile nearest cluster-entry
// distance.
//
// K1 replaces pathtracer/kernels/pallas_cull.py:_cull_kernel (called through
// tile_cull -> _tile_cull_impl). For each tile of R rays and each cluster
// AABB it runs the slab test with the precomputed 1/d and writes
//   out[tile, c] = min over the tile's rays of max(tn, 0)
// over the rays that pass (tn <= tf) & (tf >= t_min) & (tn <= t_max),
// +inf where none passes - the accept test and clamp of
// pallas_cull.py:48-63 exactly. The arithmetic is sub, mul, min and max
// only, so the result equals the plain PyTorch version bit for bit.
//
// What bounds K1 on an H100: ALU. Each (ray, cluster) pair costs ~20 FP32
// operations and reads nothing from device memory: the tile's rays sit in
// shared memory (broadcast reads, every thread of the block reads the same
// ray at once) and each thread holds its cluster's box in registers. The
// only device-memory traffic is the [tiles, C] output row per tile, written
// coalesced. Grid = (tiles, ceil(C / 256)), one thread per cluster.
// The TPU version kept the whole [6, C] AABB table resident in VMEM and
// reduced a dense [R, C] slab; here the ray loop runs inside each thread.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// K1's slab test of box [l, h] against one ray (origin o, 1/d, bound
// tmax): sets tn to the entry distance and returns the accept test
// (tn <= tf) & (tf >= t_min) & (tn <= tmax), in the order of roundings of
// K1's loop below (pallas_cull.py:48-63). K4 tests every pair through it.
__device__ __forceinline__ bool slab_accept(float lx, float ly, float lz,
                                            float hx, float hy, float hz,
                                            float ox, float oy, float oz,
                                            float ix, float iy, float iz,
                                            float tmax, float t_min,
                                            float& tn) {
  float t1 = (lx - ox) * ix, t2 = (hx - ox) * ix;
  tn = fminf(t1, t2);
  float tf = fmaxf(t1, t2);
  t1 = (ly - oy) * iy;
  t2 = (hy - oy) * iy;
  tn = fmaxf(tn, fminf(t1, t2));
  tf = fminf(tf, fmaxf(t1, t2));
  t1 = (lz - oz) * iz;
  t2 = (hz - oz) * iz;
  tn = fmaxf(tn, fminf(t1, t2));
  tf = fminf(tf, fmaxf(t1, t2));
  return (tn <= tf) && (tf >= t_min) && (tn <= tmax);
}

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

// K4 block-gated tile cull: the same out[tiles, C] as K1, equal to it.
//
// Replaces pathtracer/kernels/pallas_cull.py:_cull_kernel_skip with its
// supercluster mask _sc_mask (called at :204). The clusters fall into NB
// blocks of `blk` consecutive ids; ub [NB + 1][6] holds each block's union
// box (lo, hi) over the clusters padded to a multiple of 128 with 1e30
// boxes (pallas_cull.py:183-189, :120-121) and, in row NB, the root box:
// the union of them all. The wrapper derives ub once per box table and blk.
//
// One CTA of 256 threads per tile:
//  1. live rays: thread i < R loads ray i (seven 4-byte loads, coalesced
//     over the warp) and tests it against the root box; the rays that
//     pass are compacted, in order, into shared memory as two float4
//     (o, 1/d.x | 1/d.y, 1/d.z, t_max, 0). Each ray is read once, by its
//     own thread, so registers are its staging: a cp.async copy of the
//     [R, 3] rows would add a barrier and a second copy for 1.8 KB;
//  2. the gate: warp w tests union boxes w, w + 8, ... against every live
//     ray, one ray a lane; the ballots give each block's set of live rays
//     that pass its union box (pass[b][word]). A block is kept where the
//     set is not empty: its flag is mask_out[tile, b], and warp 0 lists
//     the kept blocks from the front of ids[] and the gated ones from the
//     back;
//  3. gated blocks: one warp a block writes +inf over the block's
//     clusters, 16-byte stores where the row is aligned (C and blk
//     multiples of 4), with no slab test;
//  4. kept blocks: threads stride over (kept block, four clusters)
//     items; a thread holds its four boxes in registers and loops over its
//     block's passing rays (set bits, lowest first), broadcast from shared
//     memory, in K1's arithmetic - four independent tests a ray load. A
//     round with fewer items than threads (a tile with few kept blocks,
//     or the last round) gives each item 2, 4 or 8 threads, each taking
//     every 2nd, 4th or 8th ray bit, merged by a shuffle of minima.
//
// Exactness. A child box lies inside its block's union box, and every
// box inside the root box. Correctly rounded sub and mul by a fixed 1/d,
// min and max are monotone, so against a box inside another a ray's tn
// is >= the outer box's tn and its tf <= the outer box's tf (the min/max
// of each axis pair keep the order: for 1/d > 0, t(lo) <= t(hi); for
// 1/d < 0 the reverse). So a ray that fails the outer box's accept test
// fails it for every inner box: tn > tf, tf < t_min and tn > t_max each
// carry over. (This needs finite boxes and origins and a finite nonzero
// 1/d, as packet._safe_inv gives: no product is then NaN.) Hence:
//  - a ray that fails the root box fails every union box and cluster, and
//    dropping it changes neither out nor the mask;
//  - a kept block's cluster gets no entry from a ray outside the block's
//    set, so its minimum over the set equals K1's over all rays (min does
//    not depend on order, and K1's +inf terms change nothing);
//  - a gated block's clusters are +inf, as K1 finds.
// The rule is geometric and needs no case for parked rays (origin 1e30):
// one whose test against the root box passes is kept. That happens where
// it can enter a box: pad boxes (lo = hi = 1e30) at t = 0 when t_min is 0
// (every occlusion call), so a block that holds pads, whose union reaches
// 1e30, stays kept for it; and real boxes when its three 1/d components
// round to one negative value, which makes tn == tf finite (about 1e30
// times |1/d|) for every real box, accepted when t_max is at least that.
// The minimum of equal values from different rays is the same value, so
// splitting an item's rays over threads and merging with fminf gives the
// same bits (up to the sign of a zero entry, which compares equal).
//
// What bounds it on an H100: FP32 instructions - per live ray the root
// and NB union tests, and per kept block its passing rays times its
// clusters (28 each, -fmad=false). The device-memory traffic is the
// tile's rays (28 B a ray), the kept blocks' boxes (24 B a cluster, from
// L2) and the output row.

constexpr int kSkipThreads = 256;
constexpr int kSkipWarps = kSkipThreads / 32;
constexpr int kBoxes = 4;   // cluster boxes a K4 thread holds in registers

__global__ void __launch_bounds__(kSkipThreads)
    tile_cull_skip_kernel(const float* __restrict__ lo,
                          const float* __restrict__ hi,
                          const float* __restrict__ ub,
                          const float* __restrict__ o,
                          const float* __restrict__ inv_d,
                          const float* __restrict__ t_max, float t_min,
                          int n_clusters, int tile_rays, int blk, int nb,
                          float* __restrict__ out,
                          int* __restrict__ mask_out) {
  extern __shared__ float4 sk[];
  const int nr = tile_rays, nw = (tile_rays + 31) >> 5;
  float4* ra = sk;                                   // [nr] o, 1/d.x
  float4* rb = ra + nr;                              // [nr] 1/d.yz, t_max
  unsigned* pass = reinterpret_cast<unsigned*>(rb + nr);   // [nb][nw]
  int* keep = reinterpret_cast<int*>(pass + nb * nw);      // [nb]
  int* ids = keep + nb;                  // [nb] kept from front, gated back
  int* cnt = ids + nb;                   // [kSkipWarps] live rays, n_kept
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const size_t tile = blockIdx.x;

  // 1. live rays, compacted in order
  float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f), b = a;
  bool live = false;
  if (threadIdx.x < nr) {
    const size_t r = tile * nr + threadIdx.x;
    a = make_float4(o[3 * r], o[3 * r + 1], o[3 * r + 2], inv_d[3 * r]);
    b = make_float4(inv_d[3 * r + 1], inv_d[3 * r + 2], t_max[r], 0.0f);
    const float* q = ub + 6 * nb;
    float tn;
    live = slab_accept(q[0], q[1], q[2], q[3], q[4], q[5], a.x, a.y, a.z,
                       a.w, b.x, b.y, b.z, t_min, tn);
  }
  const unsigned lm = __ballot_sync(0xffffffffu, live);
  if (lane == 0) cnt[warp] = __popc(lm);
  __syncthreads();
  int n_live = 0, at = 0;
  for (int w = 0; w < kSkipWarps; ++w) {
    at += w < warp ? cnt[w] : 0;
    n_live += cnt[w];
  }
  if (live) {
    at += __popc(lm & below);
    ra[at] = a;
    rb[at] = b;
  }
  __syncthreads();

  // 2. the gate: each union box against the live rays, one warp a box
  for (int u = warp; u < nb; u += kSkipWarps) {
    const float* q = ub + 6 * u;
    const float ulx = q[0], uly = q[1], ulz = q[2];
    const float uhx = q[3], uhy = q[4], uhz = q[5];
    unsigned any = 0;
    for (int w = 0; w < nw; ++w) {
      const int r = 32 * w + lane;
      bool hit = false;
      if (r < n_live) {
        const float4 x = ra[r], y = rb[r];
        float tn;
        hit = slab_accept(ulx, uly, ulz, uhx, uhy, uhz, x.x, x.y, x.z, x.w,
                          y.x, y.y, y.z, t_min, tn);
      }
      const unsigned m = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) pass[u * nw + w] = m;
      any |= m;
    }
    if (lane == 0) {
      keep[u] = any != 0u;
      if (mask_out != nullptr) mask_out[tile * nb + u] = any != 0u;
    }
  }
  __syncthreads();
  if (warp == 0) {
    int nk = 0, ng = 0;
    for (int u0 = 0; u0 < nb; u0 += 32) {
      const int u = u0 + lane;
      const bool in = u < nb, k = in && keep[u];
      const unsigned km = __ballot_sync(0xffffffffu, k);
      const unsigned gm = __ballot_sync(0xffffffffu, in && !k);
      if (k) ids[nk + __popc(km & below)] = u;
      else if (in) ids[nb - 1 - ng - __popc(gm & below)] = u;
      nk += __popc(km);
      ng += __popc(gm);
    }
    if (lane == 0) cnt[0] = nk;
  }
  __syncthreads();
  const int n_kept = cnt[0];

  // 3. gated blocks: +inf, no slab test
  float* row = out + tile * n_clusters;
  const bool vec = ((n_clusters | blk) & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  for (int j = warp; j < nb - n_kept; j += kSkipWarps) {
    const int c0 = ids[nb - 1 - j] * blk;
    const int c1 = min(c0 + blk, n_clusters);
    if (vec) {
      const float4 inf4 = make_float4(INFINITY, INFINITY, INFINITY, INFINITY);
      for (int c = c0 + 4 * lane; c < c1; c += 128)
        *reinterpret_cast<float4*>(row + c) = inf4;
    } else {
      for (int c = c0 + lane; c < c1; c += 32) row[c] = INFINITY;
    }
  }

  // 4. kept blocks: (block, kBoxes clusters) items over their passing rays;
  // a round with fewer items than threads gives each item 2, 4 or 8
  // threads, each taking every 2nd, 4th or 8th ray bit
  const int per_block = (blk + kBoxes - 1) / kBoxes;
  const int items = n_kept * per_block;
  for (int i0 = 0; i0 < items;) {
    const int left = items - i0;
    const int split = left * 8 <= kSkipThreads   ? 8
                      : left * 4 <= kSkipThreads ? 4
                      : left * 2 <= kSkipThreads ? 2 : 1;
    const int part = threadIdx.x & (split - 1);
    const unsigned bits = (split == 1   ? 0xffffffffu
                           : split == 2 ? 0x55555555u
                           : split == 4 ? 0x11111111u : 0x01010101u)
                          << part;
    const int it = i0 + threadIdx.x / split;
    i0 += kSkipThreads / split;
    int u = 0, c0 = 0, n = 0;
    if (it < items) {
      const int j = it / per_block;
      u = ids[j];
      c0 = u * blk + (it - j * per_block) * kBoxes;
      n = min(min(kBoxes, (u + 1) * blk - c0), n_clusters - c0);
    }
    float box[kBoxes][6], best[kBoxes];
#pragma unroll
    for (int k = 0; k < kBoxes; ++k) {
      const int c = k < n ? c0 + k : 0;   // an unused slot reads cluster 0
      box[k][0] = lo[3 * c];
      box[k][1] = lo[3 * c + 1];
      box[k][2] = lo[3 * c + 2];
      box[k][3] = hi[3 * c];
      box[k][4] = hi[3 * c + 1];
      box[k][5] = hi[3 * c + 2];
      best[k] = INFINITY;
    }
    for (int w = 0; n > 0 && w < nw; ++w) {
      unsigned m = pass[u * nw + w] & bits;
      while (m != 0u) {
        const int r = 32 * w + __ffs(m) - 1;
        m &= m - 1u;
        const float4 x = ra[r], y = rb[r];
#pragma unroll
        for (int k = 0; k < kBoxes; ++k) {
          float tn;
          const bool hit =
              slab_accept(box[k][0], box[k][1], box[k][2], box[k][3],
                          box[k][4], box[k][5], x.x, x.y, x.z, x.w, y.x, y.y,
                          y.z, t_min, tn);
          best[k] = fminf(best[k], hit ? fmaxf(tn, 0.0f) : INFINITY);
        }
      }
    }
    for (int s = 1; s < split; s <<= 1) {
#pragma unroll
      for (int k = 0; k < kBoxes; ++k)
        best[k] = fminf(best[k], __shfl_xor_sync(0xffffffffu, best[k], s));
    }
    if (part == 0) {
#pragma unroll
      for (int k = 0; k < kBoxes; ++k)
        if (k < n) row[c0 + k] = best[k];
    }
  }
}

// shared memory of one K4 CTA: two float4 per ray, nb x ceil(R / 32)
// pass words, nb flags, nb ids, kSkipWarps counts
size_t skip_shmem_bytes(int tile_rays, int nb) {
  const size_t nw = (tile_rays + 31) / 32;
  return 32 * (size_t)tile_rays + 4 * (size_t)nb * (nw + 2) +
         4 * (size_t)kSkipWarps;
}

// Once per size: allow dynamic shared memory beyond the 48 KB default
// (many narrow blocks), so a launch makes no attribute call.
size_t skip_shmem_set = 48 * 1024;

cudaError_t prepare_skip(size_t shmem) {
  if (shmem <= skip_shmem_set) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)tile_cull_skip_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (e == cudaSuccess) skip_shmem_set = shmem;
  return e;
}

}  // namespace

extern "C" int pt_tile_cull_skip(const float* aabb_lo, const float* aabb_hi,
                                 const float* ub, const float* o,
                                 const float* inv_d, const float* t_max,
                                 float t_min, int n_tiles, int n_clusters,
                                 int tile_rays, int blk, int nb, float* out,
                                 int* mask_out, void* stream) {
  const size_t shmem = skip_shmem_bytes(tile_rays, nb);
  cudaError_t e = prepare_skip(shmem);
  if (e != cudaSuccess) return (int)e;
  tile_cull_skip_kernel<<<n_tiles, kSkipThreads, shmem,
                          (cudaStream_t)stream>>>(
      aabb_lo, aabb_hi, ub, o, inv_d, t_max, t_min, n_clusters, tile_rays,
      blk, nb, out, mask_out);
  return (int)cudaGetLastError();
}

// Registers and local (spill) bytes a thread, and resident CTAs an SM of
// K4 for tile_rays rays a tile and nb union boxes; *threads = threads a CTA.
extern "C" int pt_tile_cull_skip_info(int tile_rays, int nb, int* regs,
                                      int* local_bytes, int* blocks_per_sm,
                                      int* threads) {
  const size_t shmem = skip_shmem_bytes(tile_rays, nb);
  cudaError_t e = prepare_skip(shmem);
  cudaFuncAttributes a;
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&a, (const void*)tile_cull_skip_kernel);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *threads = kSkipThreads;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, (const void*)tile_cull_skip_kernel, kSkipThreads,
      shmem);
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
