// P1-P3: the TPU micro-probes of the JAX package's benchmarks/ as Hopper
// kernels, each beside a plain PyTorch version in kernels/probes.py.
//
// P1 chain_kernel<float> / chain_kernel<__nv_bfloat162> replace
//   benchmarks/bf16_probe.py:pallas_chain (kernel `kern`): `steps` (the
//   probe's 512 x 8) steps of t1 = (x - y) * x, t2 = (y - x) * y, x = min(t1, t2) * 0.25
//   + 0.5, y = max(t1, t2) * 0.25 + 0.51, then x + y, elementwise. One
//   thread an element in f32; one thread a pair of elements in packed
//   __nv_bfloat162 (__hsub2, __hmul2, __hmin2, __hmax2, __hadd2: one
//   instruction for two elements, each correctly rounded to bf16, which
//   is what torch's bf16 ops give). The question is whether packed bf16x2
//   beats f32 on the SM, so the instructions are fixed here rather than
//   left to a compiler that may widen bf16 to f32. Bound by operations:
//   10 instructions a step (with -fmad=false a*0.25+0.5 is a multiply
//   and an add), for one element in f32 and two in bf16x2; 8 MB of data.
//
// P2 cond_walk_kernel<kGate> replaces benchmarks/cond_probe.py:_kernel:
//   a walk of n_iter fake columns t = x + i over a [64, 512] tile; each
//   step takes every row's min tj; the extraction - each row's argmin j
//   (first column on a tie), uj = t[j] picked by a one-hot select over
//   the row's columns, and (best, aux) updated where tj < best - runs
//   always, or with kGate only when min(tj) < min(best) + 100 over the
//   tile (a grid-step-uniform branch). As in the Pallas kernel every step
//   computes tj and only the extraction computes the argmin, the select
//   and the update. Every grid step writes the same output, as every grid
//   step of the Pallas call does.
//   t = x + i needs a thread's own x values only, so each thread holds
//   its share of the tile in registers, read once: a grid step is a
//   thread-block cluster of two CTAs of 512 threads and 32 rows each (64
//   steps: 128 CTAs on 128 of the card's 132 SMs); a row is 16
//   consecutive threads of 32 contiguous columns each, and its min and
//   argmin finish with xor shuffles inside them. The gate's two minima
//   (min tj and min best over the tile) are taken per warp by shuffles,
//   written by lane 0 into a slot of both CTAs (the partner's through
//   distributed shared memory), and read back after one cluster barrier
//   a step: slots alternate by step parity, so a step needs no second
//   barrier, and the next step's tj is computed between the barrier's
//   arrive and wait. That barrier spans both CTAs, which K2 (one CTA a
//   tile) would not need, so gated / always here is the cost of this
//   gate, not what a skip in K2 would save. Bound by operations: the add
//   and the min of every element each step, plus the extraction's
//   compare and select where it runs.
//
// P3 attrib_kernel<V> replaces benchmarks/sweep_attrib.py:_kernel: K2's
//   structure (csrc/sweep.cu: one block of 256 threads a 64-ray tile,
//   four threads a ray over interleaved lanes, a double-buffered 16-byte
//   cp.async ring of lane-major rows, one barrier a column, candidates
//   merged after it) walking a synthetic schedule of n_cols columns of cpi
//   clusters each. The column body - candidate seed, merge and tile
//   maximum, lane tests - is K2's own code, from sweep_column.cuh; only
//   the walk's staging and stop rule are P3's. Five variants:
//     empty  the loop, its barrier and its schedule read;
//     nodma  + the Baldwin-Weber lane test and K2's candidate merge and
//            tile maximum, on a zeroed ring slot (no copies);
//     noalu  + the ring: cpi copies a column (ids read one column ahead
//            through shared memory), one wait; each thread then reads one
//            row-0 value of the column's lanes, so the copy feeds the
//            output;
//     dma1   as noalu, with ONE contiguous copy of cpi clusters a column;
//     full   everything: a column then costs what a K2 column costs (at
//            cpi 1).
//   The stop rule is the JAX kernel's - col < n_cols, the column's first
//   schedule entry finite, acc < 3e38 - and, in the two variants that
//   test lanes, also K2's (the entry below the tile's largest best t); on
//   the probe's schedule (entries 0 or +inf) with t_min >= 0 that one
//   never fires. The output is best_t + acc: the nearest hit over every
//   visited lane (no id filter, as in the JAX probe) plus the column
//   count; +inf where no hit (every variant but full). As in K2 the lane
//   test rejects on signs before the reciprocal, so a lane's cost depends
//   on its data: on nodma's zeroed rows every lane rejects at its first
//   test. Bound by operations: the FP32 instructions of the lane tests
//   this run's data takes (sign stage for every lane, the reciprocal and
//   t range for lanes that pass the signs, u and v for lanes in range),
//   counted by the plain version.
//
// Built with -fmad=false: every expression rounds as in the plain
// versions, so kernel and plain version agree bit for bit.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// K2's column body (csrc/sweep.cu's): P3's full variant runs it as it is
#include "sweep_column.cuh"

namespace {

// ---- P1 -----------------------------------------------------------------

constexpr int kUnroll = 8;   // chain steps a fori iteration (bf16_probe UNROLL)

// one chain step of the JAX probe's chain_unit
__device__ __forceinline__ void chain_step(float& a, float& b) {
  const float t1 = (a - b) * a;
  const float t2 = (b - a) * b;
  a = fminf(t1, t2) * 0.25f + 0.5f;
  b = fmaxf(t1, t2) * 0.25f + 0.51f;
}

__device__ __forceinline__ void chain_step(__nv_bfloat162& a,
                                           __nv_bfloat162& b) {
  // the JAX chain's weakly typed constants become bf16
  const __nv_bfloat162 q = __float2bfloat162_rn(0.25f);
  const __nv_bfloat162 h = __float2bfloat162_rn(0.5f);
  const __nv_bfloat162 h51 = __float2bfloat162_rn(0.51f);
  const __nv_bfloat162 t1 = __hmul2(__hsub2(a, b), a);
  const __nv_bfloat162 t2 = __hmul2(__hsub2(b, a), b);
  a = __hadd2(__hmul2(__hmin2(t1, t2), q), h);
  b = __hadd2(__hmul2(__hmax2(t1, t2), q), h51);
}

// `steps` chain steps, kUnroll a loop iteration as the JAX probe's fori
// body, then x + y; T is float or __nv_bfloat162 (two elements)
template <typename T>
__global__ void chain_kernel(const T* __restrict__ x, const T* __restrict__ y,
                             T* __restrict__ out, int n, int steps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T a = x[i], b = y[i];
  for (int it = 0; it < steps / kUnroll; ++it) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) chain_step(a, b);
  }
  for (int s = 0; s < steps % kUnroll; ++s) chain_step(a, b);
  out[i] = a + b;
}

// ---- P2 -----------------------------------------------------------------

namespace cg = cooperative_groups;

constexpr int kRows = 64, kCols = 512;          // cond_probe's [R, L]
constexpr int kWalkCtas = 2;                    // CTAs a grid step
constexpr int kWalkThreads = 512;               // threads a CTA
constexpr int kWalkWarps = kWalkThreads / 32;
constexpr int kWalkRows = kRows / kWalkCtas;    // rows a CTA: 32
constexpr int kTpr = kWalkThreads / kWalkRows;  // threads a row: 16
constexpr int kPer = kCols / kTpr;              // columns a thread: 32
constexpr int kSlots = kWalkCtas * kWalkWarps;  // the gate's slots: 32
static_assert(kTpr <= 32 && kPer % 4 == 0 && kSlots == 32,
              "a row within a warp, a slot a lane");

// min of v over the lanes l ^ off for off = from, from * 2, ... < to
__device__ __forceinline__ float xor_min(float v, int from, int to) {
  for (int off = from; off < to; off <<= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// tj of step fi: the row's min of x + i over the row's threads (four
// chains; min is exact in any order)
__device__ __forceinline__ float row_min(const float* xv, float fi) {
  float m[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) m[k] = xv[k] + fi;
#pragma unroll
  for (int k = 4; k < kPer; ++k) m[k & 3] = fminf(m[k & 3], xv[k] + fi);
  return xor_min(fminf(fminf(m[0], m[1]), fminf(m[2], m[3])), 1, kTpr);
}

// The gated walk computes step i + 1's tj between its cluster barrier's
// arrive (which releases the slots written before it) and its wait (which
// acquires the partner's); step i's slots of one parity are rewritten at
// step i + 2 only, after every thread of both CTAs has passed step
// i + 1's barrier and so has read them. The last remote write into a CTA
// precedes the last barrier, so a CTA may exit after it.
template <bool kGate>
__global__ void __cluster_dims__(kWalkCtas, 1, 1)
    __launch_bounds__(kWalkThreads, 1)
        cond_walk_kernel(const float* __restrict__ x, int n_iter,
                         float* __restrict__ out) {
  __shared__ float red[2 * kSlots * 2];   // [parity][slot][min tj, min best]
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = rank * kWalkRows + threadIdx.x / kTpr;
  const int c0 = (threadIdx.x % kTpr) * kPer;   // the thread's columns
  float xv[kPer];
  const float4* src = reinterpret_cast<const float4*>(x + row * kCols + c0);
#pragma unroll
  for (int k = 0; k < kPer / 4; ++k) {
    const float4 v = src[k];
    xv[4 * k] = v.x;
    xv[4 * k + 1] = v.y;
    xv[4 * k + 2] = v.z;
    xv[4 * k + 3] = v.w;
  }
  float* peer = red;   // the partner CTA's slots
  if constexpr (kGate) {
    peer = cluster.map_shared_rank(red, rank ^ 1);
    cluster.sync();   // the partner runs before its slots are written
  }
  float best = 1e30f, aux = 0.0f;
  float tj = n_iter > 0 ? row_min(xv, 0.0f) : 0.0f;
  for (int i = 0; i < n_iter; ++i) {
    const float fi = (float)i;
    bool extract = true;
    float tj_next = 0.0f;
    if constexpr (kGate) {
      // the warp's rows, then every warp's slot of this step's parity
      const float wt = xor_min(tj, kTpr, 32);
      const float wb = xor_min(best, kTpr, 32);
      const int slot = 2 * ((i & 1) * kSlots + rank * kWalkWarps + warp);
      if (lane == 0) {
        red[slot] = wt;
        red[slot + 1] = wb;
        peer[slot] = wt;
        peer[slot + 1] = wb;
      }
      asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
      if (i + 1 < n_iter) tj_next = row_min(xv, (float)(i + 1));
      asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
      const float* got = red + 2 * (i & 1) * kSlots;
      const float mt = xor_min(got[2 * lane], 1, 32);
      const float mb = xor_min(got[2 * lane + 1], 1, 32);
      extract = mt < mb + 100.0f;   // the same in every thread
    }
    if (extract) {
      // argmin: the lowest column whose t equals the row's min
      int j = kCols;
#pragma unroll
      for (int k = kPer - 1; k >= 0; --k)
        if (xv[k] + fi == tj) j = c0 + k;
      for (int off = 1; off < kTpr; off <<= 1)
        j = min(j, __shfl_xor_sync(0xffffffffu, j, off));
      // uj: t at column j, by a one-hot select over the thread's columns,
      // from the row's thread that holds column j
      float v = 0.0f;
#pragma unroll
      for (int k = 0; k < kPer; ++k)
        if (c0 + k == j) v = xv[k] + fi;
      const float uj =
          __shfl_sync(0xffffffffu, v, (lane & ~(kTpr - 1)) + j / kPer);
      if (tj < best) {
        best = tj;
        aux = uj;
      }
    }
    if constexpr (kGate)
      tj = tj_next;
    else if (i + 1 < n_iter)
      tj = row_min(xv, (float)(i + 1));
  }
  if (threadIdx.x % kTpr == 0) out[row] = best + aux;
}

// ---- P3 -----------------------------------------------------------------

constexpr int kDma1Span = 1024;        // dma1's cluster range (JAX: 1024 // cpi)

enum { kEmpty = 0, kNoDma = 1, kNoAlu = 2, kDma1 = 3, kFull = 4 };

// Stage column col's cpi clusters into ring slot dst: dma1 one contiguous
// span, the others one copy a cluster with ids from `ids` (shared).
template <int V>
__device__ __forceinline__ void stage(float4* dst,
                                      const float4* __restrict__ lm,
                                      const int* ids, int col, int k,
                                      int cpi) {
  if (V == kDma1) {
    const int span = max(1, kDma1Span / cpi);
    copy16(dst, lm + (size_t)(col % span) * cpi * k * 4, cpi * k * 4);
  } else {
    for (int q = 0; q < cpi; ++q)
      copy16(dst + q * k * 4, lm + (size_t)ids[q] * k * 4, k * 4);
  }
  commit();
}

// Shared memory: ring [2][cpi * k lanes][4 float4], candidate slabs
// [2][kParts][R] x 5 words, ids [2][cpi].
size_t attrib_shmem(int tile_rays, int k, int cpi) {
  return 2 * (size_t)cpi * k * 16 * sizeof(float) + cands_bytes(tile_rays) +
         2 * (size_t)cpi * sizeof(int);
}

template <int V>
__global__ void __launch_bounds__(kMaxThreads)
    attrib_kernel(const float* __restrict__ st, const int* __restrict__ si,
                  int cs, const float* __restrict__ rays,
                  const float4* __restrict__ lm, int k, int cpi, int n_cols,
                  float t_min, float* __restrict__ out) {
  constexpr bool kDma = V == kNoAlu || V == kDma1 || V == kFull;
  constexpr bool kAlu = V == kNoDma || V == kFull;
  extern __shared__ float4 sh[];
  const int nr = blockDim.x / kParts;
  const int r = threadIdx.x % nr, p = threadIdx.x / nr;
  const int lane = threadIdx.x & 31;
  const int me = p * nr + r;
  const int col_lanes = cpi * k;
  const Cands<kParts> c(sh + 8 * col_lanes, nr);   // after the ring's slots
  int* ids = reinterpret_cast<int*>(c.end());                 // [2][cpi]
  const size_t tile = blockIdx.x;
  const float* srow = st + tile * cs;
  const int* irow = si + tile * cs;
  const float* ray = rays + tile * 6 * nr;
  const float ox = ray[r], oy = ray[nr + r], oz = ray[2 * nr + r];
  const float dx = ray[3 * nr + r], dy = ray[4 * nr + r],
              dz = ray[5 * nr + r];
  float best_t = INFINITY;
  int best_tri = -1;
  float best_u = 0.0f, best_v = 0.0f;
  if (kAlu) seed_closest(c, me, best_t);
  if (!kDma) {   // nodma tests a zeroed slot; empty reads nothing from it
    for (int i = threadIdx.x; i < 4 * col_lanes; i += blockDim.x)
      sh[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  } else {
    if (V != kDma1) {
      if (threadIdx.x < cpi) ids[threadIdx.x] = irow[threadIdx.x];
      __syncthreads();
    }
    stage<V>(sh, lm, ids, 0, k, cpi);
    if (V != kDma1 && n_cols > 1 && threadIdx.x < cpi)
      ids[cpi + threadIdx.x] = irow[cpi + threadIdx.x];   // column 1's
  }
  float st_cur = srow[0], st_next = INFINITY;
  float acc = 0.0f, touch = 0.0f;
  for (int j = 0;; ++j) {
    if (kDma) wait_copies();
    __syncthreads();
    float tile_max = INFINITY;
    if (kAlu)   // merge column j-1's candidates, then the tile's maximum
      tile_max = merge_closest(c, ((j + 1) & 1) * c.slab, nr, r, lane,
                               best_t, best_tri, best_u, best_v);
    if (!(j < n_cols && st_cur < INFINITY && acc < 3e38f &&
          st_cur < tile_max))
      break;
    int next_id = 0;
    if (j + 1 < n_cols) {
      st_next = srow[(j + 1) * cpi];
      if (kDma)
        stage<V>(sh + ((j + 1) & 1) * 4 * col_lanes, lm,
                 ids + ((j + 1) & 1) * cpi, j + 1, k, cpi);
    } else {
      st_next = INFINITY;
    }
    if (V == kNoAlu || V == kFull)
      if (threadIdx.x < cpi && j + 2 < n_cols)
        next_id = irow[(j + 2) * cpi + threadIdx.x];
    const float4* rows = sh + (kDma ? (j & 1) * 4 * col_lanes : 0);
    if (kAlu) {
      test_closest<false, kParts>(rows, col_lanes, p, ox, oy, oz, dx, dy,
                                  dz, t_min, best_t, c,
                                  (j & 1) * c.slab + me);
    } else if (kDma) {   // touch row 0 (dma1: of the first cluster)
      const int n = V == kDma1 ? k : col_lanes;
      for (int l = threadIdx.x; l < n; l += blockDim.x) touch += rows[4 * l].x;
    }
    if ((V == kNoAlu || V == kFull) && threadIdx.x < cpi)
      ids[(j & 1) * cpi + threadIdx.x] = next_id;   // column j+2's
    acc += 1.0f;
    st_cur = st_next;
  }
  if (p == 0) {
    // K2's merge also carries tri, u and v: fold them in where they cannot
    // change the output (best_tri is never kNone), so that their loads stay
    const float keep = (best_tri == kNone) ? best_u + best_v : 0.0f;
    out[tile * nr + r] = best_t + (acc + (touch + keep) * 1e-30f);
  }
}

const void* attrib_of(int variant) {
  switch (variant) {
    case kEmpty: return (const void*)attrib_kernel<kEmpty>;
    case kNoDma: return (const void*)attrib_kernel<kNoDma>;
    case kNoAlu: return (const void*)attrib_kernel<kNoAlu>;
    case kDma1: return (const void*)attrib_kernel<kDma1>;
    default: return (const void*)attrib_kernel<kFull>;
  }
}

}  // namespace

extern "C" int pt_chain_f32(const float* x, const float* y, float* out, int n,
                            int steps, void* stream) {
  const int threads = 256;
  chain_kernel<float><<<(n + threads - 1) / threads, threads, 0,
                        (cudaStream_t)stream>>>(x, y, out, n, steps);
  return (int)cudaGetLastError();
}

// n elements, n even: one thread a bf16x2 pair
extern "C" int pt_chain_bf16(const void* x, const void* y, void* out, int n,
                             int steps, void* stream) {
  const int threads = 256, n2 = n / 2;
  chain_kernel<__nv_bfloat162><<<(n2 + threads - 1) / threads, threads, 0,
                                 (cudaStream_t)stream>>>(
      (const __nv_bfloat162*)x, (const __nv_bfloat162*)y,
      (__nv_bfloat162*)out, n2, steps);
  return (int)cudaGetLastError();
}

// grid steps of one 2-CTA cluster each
extern "C" int pt_cond_walk(const float* x, int n_iter, int grid, int gate,
                            float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (gate)
    cond_walk_kernel<true><<<kWalkCtas * grid, kWalkThreads, 0, s>>>(
        x, n_iter, out);
  else
    cond_walk_kernel<false><<<kWalkCtas * grid, kWalkThreads, 0, s>>>(
        x, n_iter, out);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of attrib_kernel for tile_rays rays a tile, k lanes
// and cpi clusters a column (the wrapper checks it against the card's
// limit before it launches).
extern "C" int pt_attrib_shmem(int tile_rays, int k, int cpi) {
  return (int)attrib_shmem(tile_rays, k, cpi);
}

extern "C" int pt_sweep_attrib(int variant, const float* st, const int* si,
                               int tiles, int cs, const float* rays,
                               const float* blocks_lm, int k, int tile_rays,
                               int cpi, float t_min, float* out,
                               void* stream) {
  // the wrapper keeps shmem within the card's 232,448 bytes a block; the
  // attribute is set once per variant and size, not at every launch
  static size_t shmem_set[5] = {0, 0, 0, 0, 0};
  const size_t shmem = attrib_shmem(tile_rays, k, cpi);
  if (variant < 0 || variant > kFull) return (int)cudaErrorInvalidValue;
  if (shmem > shmem_set[variant]) {
    cudaError_t e = cudaFuncSetAttribute(
        attrib_of(variant), cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shmem);
    if (e != cudaSuccess) return (int)e;
    shmem_set[variant] = shmem;
  }
  const int n_cols = cs / cpi;
  const float4* lm = (const float4*)blocks_lm;
  const dim3 grid(tiles), block(tile_rays * kParts);
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case kEmpty:
      attrib_kernel<kEmpty><<<grid, block, shmem, s>>>(
          st, si, cs, rays, lm, k, cpi, n_cols, t_min, out);
      break;
    case kNoDma:
      attrib_kernel<kNoDma><<<grid, block, shmem, s>>>(
          st, si, cs, rays, lm, k, cpi, n_cols, t_min, out);
      break;
    case kNoAlu:
      attrib_kernel<kNoAlu><<<grid, block, shmem, s>>>(
          st, si, cs, rays, lm, k, cpi, n_cols, t_min, out);
      break;
    case kDma1:
      attrib_kernel<kDma1><<<grid, block, shmem, s>>>(
          st, si, cs, rays, lm, k, cpi, n_cols, t_min, out);
      break;
    default:
      attrib_kernel<kFull><<<grid, block, shmem, s>>>(
          st, si, cs, rays, lm, k, cpi, n_cols, t_min, out);
  }
  return (int)cudaGetLastError();
}
