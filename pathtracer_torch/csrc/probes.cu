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
//   column body (csrc/sweep_column.cuh: one block of 256 threads a 64-ray
//   tile, four threads a ray over interleaved lanes, candidates merged
//   after one barrier a column) walking a synthetic schedule of n_cols
//   columns of cpi clusters each. The column body - candidate seed,
//   merge and tile maximum, lane tests - is K2's own code; the staging
//   and the walk are P3's. Five variants:
//     empty  the loop, its barrier and its schedule read;
//     nodma  + the Baldwin-Weber lane test and K2's candidate merge and
//            tile maximum, on a zeroed ring stage (no copies);
//     noalu  + the ring: cpi bulk copies a column, one wait; each thread
//            then reads one row-0 value of the column's lanes, so the
//            copy feeds the output;
//     dma1   as noalu, with ONE bulk copy of cpi contiguous clusters;
//     full   everything.
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
//   Staging, Hopper's way (the Pallas kernel's DMA ring, and the port's
//   first copy of it, had every thread issue 16-byte cp.async copies and learn of
//   their arrival from cp.async.wait_group plus a CTA barrier). A ring of
//   S stages of cpi * k lane-major rows (cpi x 8 KB at k = 128) in
//   dynamic shared memory, S picked on the host
//   (kernels/probes.attrib_stages: the most, up to 3, that fit 227 KB
//   beside the candidate slabs; 2 from cpi 10 at k = 128). One elected
//   thread, thread 0, issues one TMA bulk copy (cp.async.bulk, global to
//   shared) a cluster of a column - dma1 one of cpi clusters - after an
//   arrive.expect_tx of the column's bytes on the stage's "full"
//   mbarrier; every thread waits on that barrier's phase parity
//   (column / S & 1) and on nothing else to learn that its rows are in.
//   The ids of the next column to copy are read from si one column
//   ahead, straight into registers of warp 0's lanes q < cpi, and
//   shuffled to thread 0 as it issues; nothing passes them through
//   shared memory.
//   The producer is that consumer thread, not a separate producer warp:
//   K2's merge needs one CTA barrier a column anyway (it reads the other
//   parts' candidates), and every thread passes it after its last read of
//   column j - 1's stage, so after the barrier of column j the stage is
//   free and thread 0 refills it with column j + S - 1. That barrier is
//   the ring's "empty" barrier. A producer warp would add 32 threads to
//   every block, an empty mbarrier a stage with 256 arrivals a column,
//   a named barrier for the consumers, and a handshake to learn of the
//   stop rule, which only the merge can evaluate; what it would take
//   off warp 0 is cpi shuffles and cpi + 1 issues a column.
//   Copies issued past a stop are waited for before the block exits (its
//   shared memory must not be handed on with copies in flight). Bulk
//   copies need 16-byte addresses and sizes: a cluster is k * 64 bytes
//   and every stage starts at a multiple of it; one phase's byte count,
//   at most 13 x 8 KB, is far below the mbarrier's 2^20 - 1. No shared
//   memory that a generic store writes is ever a TMA destination: nodma
//   zeroes stage 0 and copies nothing. A wait that outlasts ~8 s traps
//   (a copy that never lands would otherwise hang the card).
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
constexpr long long kWaitCycles = 1LL << 34;   // ~8 s at the SM's clock

enum { kEmpty = 0, kNoDma = 1, kNoAlu = 2, kDma1 = 3, kFull = 4 };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The barriers are named by their shared-memory addresses (32 bits).
__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// one arrival on bar, and `bytes` more that its phase waits to receive
__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool bar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// wait for the phase of bar whose parity is `parity` to complete
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  if (bar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!bar_try(bar, parity))
    if (clock64() - t0 > kWaitCycles) __trap();
}

// TMA bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global src to shared dst, completing on bar
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Warp 0: copy column col into its stage, col % S, of the ring at shared
// address `ring` (barriers at `full`). `ids` holds, in lane q < cpi, the
// id of the column's cluster q (unused by dma1).
template <int V, int S>
__device__ __forceinline__ void issue_column(uint32_t ring, uint32_t full,
                                             const float4* __restrict__ lm,
                                             int col, int ids, int k,
                                             int cpi) {
  const int s = col % S;
  const uint32_t cluster = (uint32_t)k * 64u, bytes = cpi * cluster;
  const uint32_t dst = ring + s * bytes, bar = full + 8u * s;
  const bool elected = threadIdx.x == 0;
  if (elected) bar_expect(bar, bytes);
  if (V == kDma1) {
    const int span = max(1, kDma1Span / cpi);
    if (elected)
      bulk_copy(dst, lm + (size_t)(col % span) * cpi * k * 4, bytes, bar);
  } else {
    for (int q = 0; q < cpi; ++q) {
      const int id = __shfl_sync(0xffffffffu, ids, q);
      if (elected)
        bulk_copy(dst + q * cluster, lm + (size_t)id * k * 4, cluster, bar);
    }
  }
}

// Shared memory: ring [stages][cpi * k lanes][4 float4], candidate slabs
// [2][kParts][R] x 5 words, full barriers [stages] (8-byte words; the
// ring's and the slabs' sizes are multiples of 16 bytes).
size_t attrib_shmem(int tile_rays, int k, int cpi, int stages) {
  return (size_t)stages * cpi * k * 16 * sizeof(float) +
         cands_bytes(tile_rays) + (size_t)stages * sizeof(uint64_t);
}

// S ring stages: 2 or 3 (attrib_stages), a template parameter. At most
// 48 registers a thread, so that 5 blocks of 256 threads share an SM as
// K2's do: left free, ptxas gives full 63-64 (4 blocks an SM) for the
// producer's state beside K2's column body; capped, it spills nothing.
constexpr int kAttribBlocks = 5;

template <int V, int S>
__global__ void __launch_bounds__(kMaxThreads, kAttribBlocks)
    attrib_kernel(const float* __restrict__ st, const int* __restrict__ si,
                  int cs, const float* __restrict__ rays,
                  const float4* __restrict__ lm, int k, int cpi, int n_cols,
                  float t_min, float* __restrict__ out) {
  constexpr bool kDma = V == kNoAlu || V == kDma1 || V == kFull;
  constexpr bool kAlu = V == kNoDma || V == kFull;
  constexpr bool kIds = V == kNoAlu || V == kFull;   // copies by cluster id
  extern __shared__ float4 sh[];
  const int nr = blockDim.x / kParts;
  const int r = threadIdx.x % nr, p = threadIdx.x / nr;
  const int lane = threadIdx.x & 31;
  const bool warp0 = threadIdx.x < 32;
  const int me = p * nr + r;
  const int col_lanes = cpi * k;
  const Cands<kParts> c(sh + (size_t)S * 4 * col_lanes, nr);
  const uint32_t ring = smem_addr(sh);
  const uint32_t full = smem_addr(c.end());   // S barriers, 8 bytes each
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
  int ids = 0;   // warp 0, lane q < cpi: cluster q of the next column to copy
  if (!kDma) {   // nodma tests a zeroed stage; empty reads nothing from it
    for (int i = threadIdx.x; i < 4 * col_lanes; i += blockDim.x)
      sh[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  } else {
    if (threadIdx.x == 0) {
      for (int s = 0; s < S; ++s) bar_init(full + 8u * s, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();   // the barriers exist before anyone waits on them
    if (warp0) {       // columns 0 .. S-2 fill the ring's first stages
      const int first = min(S - 1, n_cols);
      for (int col = 0; col < first; ++col) {
        if (kIds && lane < cpi) ids = irow[col * cpi + lane];
        issue_column<V, S>(ring, full, lm, col, ids, k, cpi);
      }
      if (kIds && lane < cpi && first < n_cols)
        ids = irow[first * cpi + lane];
    }
  }
  float st_cur = srow[0];
  float acc = 0.0f, touch = 0.0f;
  int s = 0;           // column j's stage, j % S
  uint32_t phase = 0;  // the parity of its use, (j / S) & 1
  int j = 0;
  for (;; ++j) {
    // every thread has read column j-1's stage and written its candidate
    __syncthreads();
    float tile_max = INFINITY;
    if (kAlu)   // merge column j-1's candidates, then the tile's maximum
      tile_max = merge_closest(c, ((j + 1) & 1) * c.slab, nr, r, lane,
                               best_t, best_tri, best_u, best_v);
    if (!(j < n_cols && st_cur < INFINITY && acc < 3e38f &&
          st_cur < tile_max))
      break;
    const float st_next = j + 1 < n_cols ? srow[(j + 1) * cpi] : INFINITY;
    const float4* rows = sh;
    if (kDma) {
      // column j-1's stage is free: refill it with column j + S - 1
      const int col = j + S - 1;
      if (warp0 && col < n_cols) {
        issue_column<V, S>(ring, full, lm, col, ids, k, cpi);
        if (kIds && lane < cpi && col + 1 < n_cols)
          ids = irow[(col + 1) * cpi + lane];
      }
      bar_wait(full + 8u * s, phase);
      rows = sh + (size_t)s * 4 * col_lanes;
      if (++s == S) {
        s = 0;
        phase ^= 1u;
      }
    }
    if (kAlu) {
      test_closest<false, kParts>(rows, col_lanes, p, ox, oy, oz, dx, dy,
                                  dz, t_min, best_t, c,
                                  (j & 1) * c.slab + me);
    } else if (kDma) {   // touch row 0 (dma1: of the first cluster)
      const int n = V == kDma1 ? k : col_lanes;
      for (int l = threadIdx.x; l < n; l += blockDim.x) touch += rows[4 * l].x;
    }
    acc += 1.0f;
    st_cur = st_next;
  }
  if (kDma && threadIdx.x == 0) {
    // columns j .. j + S - 2 may be in flight: they land before the exit
    const int issued = min(n_cols, j + S - 1);
    for (int col = j; col < issued; ++col)
      bar_wait(full + 8u * (col % S), (uint32_t)(col / S) & 1u);
  }
  if (p == 0) {
    // K2's merge also carries tri, u and v: fold them in where they cannot
    // change the output (best_tri is never kNone), so that their loads stay
    const float keep = (best_tri == kNone) ? best_u + best_v : 0.0f;
    out[tile * nr + r] = best_t + (acc + (touch + keep) * 1e-30f);
  }
}

template <int V>
const void* attrib_of_stages(int stages) {
  return stages == 2 ? (const void*)attrib_kernel<V, 2>
                     : (const void*)attrib_kernel<V, 3>;
}

// the kernel of a variant and a ring of 2 or 3 stages
const void* attrib_of(int variant, int stages) {
  switch (variant) {
    case kEmpty: return attrib_of_stages<kEmpty>(stages);
    case kNoDma: return attrib_of_stages<kNoDma>(stages);
    case kNoAlu: return attrib_of_stages<kNoAlu>(stages);
    case kDma1: return attrib_of_stages<kDma1>(stages);
    default: return attrib_of_stages<kFull>(stages);
  }
}

// cudaFuncAttributeMaxDynamicSharedMemorySize of a kernel, raised to
// `shmem` where it is below (set once per kernel and size, not at every
// launch; the wrapper keeps shmem within the card's 232,448 bytes)
cudaError_t attrib_allow(int variant, int stages, size_t shmem) {
  static size_t shmem_set[5][2] = {};
  size_t& set = shmem_set[variant][stages - 2];
  if (shmem <= set) return cudaSuccess;
  const void* fn = attrib_of(variant, stages);
  // as K2: the largest shared-memory carveout, since shared memory
  // limits how many blocks share an SM
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (e == cudaSuccess) set = shmem;
  return e;
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

// Dynamic shared memory of attrib_kernel for tile_rays rays a tile, k
// lanes, cpi clusters a column and a ring of `stages` (the wrapper checks
// it against the card's limit before it launches).
extern "C" int pt_attrib_shmem(int tile_rays, int k, int cpi, int stages) {
  return (int)attrib_shmem(tile_rays, k, cpi, stages);
}

// Registers and local bytes a thread of a variant with a ring of
// `stages`, and its resident blocks an SM at tile_rays * kParts threads
// and the shared memory of (tile_rays, k, cpi, stages).
extern "C" int pt_attrib_info(int variant, int tile_rays, int k, int cpi,
                              int stages, int* regs, int* local, int* blocks,
                              int* threads) {
  if (variant < 0 || variant > kFull || stages < 2 || stages > 3)
    return (int)cudaErrorInvalidValue;
  const size_t shmem = attrib_shmem(tile_rays, k, cpi, stages);
  cudaFuncAttributes a;
  cudaError_t e = attrib_allow(variant, stages, shmem);
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&a, attrib_of(variant, stages));
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local = (int)a.localSizeBytes;
  *threads = tile_rays * kParts;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, attrib_of(variant, stages), *threads, shmem);
}

extern "C" int pt_sweep_attrib(int variant, const float* st, const int* si,
                               int tiles, int cs, const float* rays,
                               const float* blocks_lm, int k, int tile_rays,
                               int cpi, int stages, float t_min, float* out,
                               void* stream) {
  if (variant < 0 || variant > kFull || stages < 2 || stages > 3)
    return (int)cudaErrorInvalidValue;
  const size_t shmem = attrib_shmem(tile_rays, k, cpi, stages);
  cudaError_t e = attrib_allow(variant, stages, shmem);
  if (e != cudaSuccess) return (int)e;
  int n_cols = cs / cpi;
  const float4* lm = (const float4*)blocks_lm;
  void* args[] = {&st, &si, &cs, &rays, &lm, &k, &cpi, &n_cols, &t_min, &out};
  e = cudaLaunchKernel(attrib_of(variant, stages), dim3(tiles),
                       dim3(tile_rays * kParts), args, shmem,
                       (cudaStream_t)stream);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
