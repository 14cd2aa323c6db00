// K2 closest sweep, K3 occlusion sweep and K3b occlusion sweep with
// blocker hints, over the per-tile cluster schedule.
//
// Replaces pathtracer/kernels/pallas_sweep.py:_sweep_kernel (through
// sweep_closest) and :_occl_kernel (through sweep_occluded, K3 without and
// K3b with want_blocker), with the Baldwin-Weber lane test of _bw_lane.
//
// Layout: one block per tile, P = parts(R) threads per ray (R = 64 rays,
// four a ray, 256 threads by default; R = 32 with four a ray in 128
// threads; R = 128 and 256 with two and one a ray, 256 threads, one
// instantiation of each kernel per P): the ray's P threads test
// interleaved parts of each column's lanes. The block walks its tile's
// near-to-far schedule st/si [tiles, Cs] with a two-slot ring of staged
// clusters in shared memory: while the rays test column j's cluster,
// column j+1's is in flight (16-byte cp.async).
//
// Why four threads a ray: a tile's walk is sequential (whether column
// j+1 is visited depends on column j's hits), and the longest walks set
// a launch's time: on the headline's bounce batches a few tiles walk
// 150-260 columns against a median of 20-30, and a chunk's 8 longest
// tiles alone take most of its time (tools/sweep_tail.py). With one
// thread a ray such a tile ran on 2 warps; four parts give it 8 warps of
// one SM. More parts, two lanes interleaved per iteration, or a
// branch-free lane body were not faster on the card: the long walk is
// then bound by its lane tests at one SM's issue rate. Wide tiles keep
// the 256-thread block (and with it the registers and blocks an SM of
// the 64-ray kernels) and give each ray fewer threads; the merge rule
// below does not depend on P, so a ray's hit does not either.
//
// Tables (accel/cluster.py, derived once from blocks_t [C, 16, K]):
//   blocks_lm f32[C, K, 16]: each lane's 16 Baldwin-Weber rows contiguous
//     (n, d | r1, c1 | r2, c2 | id + 1, 0, 0, 0), 64 B a lane. Staging a
//     column is one contiguous copy, and a lane test reads its rows with
//     float4 loads that every thread of the warp makes at one address (a
//     broadcast). A copy kept beside blocks_t was chosen over transposing
//     [16, K] while staging: the transpose's 16-float stride would put a
//     warp's stores into one bank, and the copy costs 64 B a lane once.
//   n_lanes i32[C]: 1 + the last lane whose id row is > 0 (0 for a pad
//     cluster). The build packs a cluster's triangles first, so the lanes
//     past n_lanes are pads: zero normal, never a hit. Only lanes below
//     n_lanes are staged and tested.
//
// One barrier per column. At its top every thread has waited for its own
// copies of column j, so after it the whole cluster is visible; every
// thread has finished column j-1, so ring slot (j+1)&1 may be refilled;
// and column j-1's candidates are in their slab. Every thread then merges
// them for its ray and, over all R rays, for the stop rule, so each warp
// computes the same decision without a second barrier: K2 stops when
// st[j] is not below the maximum of the rays' best t; K3/K3b when no ray
// is open (not blocked, t_max > 0) or st[j] reaches +inf. A ray with
// t_max <= 0 can never be blocked, so settling it changes no result; a
// thread whose ray is blocked or settled, or (K2) has best t <= t_min,
// skips the lane loop, which is also exact.
//
// Exact rejects before the reciprocal: a hit needs t > t_min >= 0 (the
// wrappers check t_min >= 0), and t = (d - n.o) * (1/denom) rounded is > 0
// only if d - n.o and denom have one strict sign; K3/K3b first need
// denom < -eps (front-facing). A lane that survives computes t, then
// u and v, in the plain versions' order of roundings, and is rejected on
// the t range before u and v are formed: the hit test is one conjunction.
//
// K2 keeps the nearest (t, tri, u, v) per ray, seeded from the scene-exit
// cap t_cap; a lane replaces the best only with a strictly smaller t
// ("first minimum wins" in a cluster, "earlier column wins" across them).
// K3 marks a ray blocked at its first front-facing hit with 0 < t < t_max.
// K3b, in the first column where a ray becomes blocked, scans every lane
// and keeps the blocking lane with the smallest t (the lowest lane on a
// tie, the argmin of pallas_sweep.py:294-307) and writes its triangle id;
// -1 where the ray stays open.
//
// Built with -fmad=false: every expression is a rounded product and a
// rounded sum in the plain PyTorch versions' order, and 1/denom is the
// correctly rounded reciprocal, so kernel and plain version agree hit for
// hit and bit for bit.
//
// What bounds it on an H100: FP32 instructions (~38-40 per needed
// (ray, triangle) test) in the bulk of a launch, and at its end the
// longest tiles' walks; beyond the needed tests it runs those of rays
// whose tile walks on for other rays. The ~2.8k-cluster table of the
// headline scene is ~23 MB and stays in the 50 MB L2.
//
// K2's tail: two passes. On the headline's bounce chunks a tile walks
// ~33 columns on average, but a few walk 150-260, each on one CTA, and
// the SM that runs it spends ~4.8 us a column bound by latency, not by
// instruction throughput, while the other SMs wait. Pass A (sweep_closest_kernel) walks
// every tile as above up to a budget of L columns (RESUME_COLUMNS in
// kernels/sweep.py): a tile that stops within L columns ends as before;
// one still walking at column L writes its rays' running best (t, tri,
// u, v) as it would at its end and publishes its index in a list. Pass B
// (sweep_resume_kernel), launched next on the stream over a fixed grid
// of as many clusters of N CTAs as the card holds, finishes each listed
// tile from column L in rounds of N columns: CTA q tests column
// L + N m + q seeded with the state at the round's start, and after one
// cluster barrier every CTA merges the round's candidates in column
// order, with the stop rule (st[j] < the tiles' largest best t) before
// each column, as merge_closest does. Pass B is pass A's programmatic
// dependent: once every CTA of pass A has started, its clusters take
// SMs as pass A's last CTAs leave them and take each tile as soon as
// pass A lists it, so the long walks' rest overlaps pass A's bulk (run
// after pass A, the two passes were no faster than one on the headline's
// bounce chunks: pass B's rounds then came after the bulk). A walk's own
// length decides whether pass B runs it: primary tiles, whose schedules
// are long but whose walks are ~1.6 columns, and the median bounce tile
// never reach it; an empty list costs pass B's clusters a wait for pass
// A's end.
//
// L = 48 and N = 4 (RESUME_COLUMNS and kResumeCtas), from
// tools/sweep_tail.py's timings on an H100 80GB HBM3 at 700 W, with L
// and N varied: K2 on the headline's four sampled bounce-1 chunks took
// 5.684 ms in one pass, 4.728 at L:N 48:4, 4.775 at 40:4, 4.813 at
// 56:4, 4.913 at 64:4 and 4.967 at 48:2; in an earlier run 4.747 at
// 48:4, 4.950 at 32:4, 4.948 at 32:2, 5.373 at 96:4 and 5.468 at 128:4.
// A round of N = 4 columns costs a lone tile ~7.5-8 us against ~4.9 us
// a column in one pass (N = 2: ~6.4 us); a smaller L sends more of the
// bulk through the rounds, a larger one leaves more of the tail in pass
// A. Pass B on 512-thread CTAs (twice the threads a ray) was slower:
// 5.23-5.25 ms at 48:4, half the clusters fit.
//
// Why the result is unchanged, bit for bit sweep_closest_plain's:
// - pass A's state at column L is the sequential walk's state there;
// - a column's candidate computed with a stale seed s >= the true best b
//   is the first minimum over the lanes with t < s, a superset of those
//   with t < b. The merge takes it only if its t < b; then the lanes
//   with that t all lie below b, so it is the first minimum the true
//   seed gives. Otherwise the sequential walk finds no candidate there.
//   Either way the merge's state after the column is the sequential one;
// - the merge applies the stop rule to that state before each column,
//   so the visited columns are the sequential prefix and the columns of
//   a round past the stop are discarded.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// kParts, kNone, the copies, the lane test's parts and K2's column body
// (candidate slabs, merge, lane tests), shared with P3 in csrc/probes.cu
#include "sweep_column.cuh"

namespace {

namespace cg = cooperative_groups;

// Stage the first n lane rows of cluster cid (n x 64 B) into ring slot
// dst: 16-byte cp.async by every thread, committed as one group.
__device__ __forceinline__ void stage(float4* dst,
                                      const float4* __restrict__ lm, int k,
                                      int cid, int n) {
  copy16(dst, lm + (size_t)cid * k * 4, 4 * n);
  commit();
}

// The tile's schedule walk: column j's cluster (n_cur real lanes) lies in
// ring slot j & 1 once ready() returned; next(j), called when column j is
// visited, puts column j+1's cluster (c_next, n_next) in flight into the
// other slot and reads ahead what the next columns need - st[j+1], the
// lane count of column j+2's cluster c_after, the cluster of column j+3 -
// so that no load is waited for where it is read. Walker<S> walks every
// S-th entry of st/si (its column j is entry S * j): one CTA of pass B's
// clusters; Walk (S = 1) the whole schedule.
template <int kStep>
struct Walker {
  const float* st;
  const int* si;
  const float4* lm;
  const int* n_lanes;
  float4* ring;
  int cs, k;   // cs: the columns of this walk
  float st_cur, st_next;
  int n_cur, c_next, n_next, c_after, n_after, c_far;

  __device__ __forceinline__ void begin() {
    st_cur = st_next = INFINITY;
    n_cur = c_next = n_next = c_after = n_after = c_far = 0;
    if (cs <= 0) return;
    st_cur = st[0];
    const int c0 = si[0];
    n_cur = n_lanes[c0];
    stage(ring, lm, k, c0, n_cur);
    if (cs > 1) {
      c_next = si[kStep];
      n_next = n_lanes[c_next];
    }
    if (cs > 2) c_after = si[2 * kStep];
  }
  // wait for this thread's copies of column j; a barrier must follow
  __device__ __forceinline__ void ready() const { wait_copies(); }
  __device__ __forceinline__ const float4* rows(int j) const {
    return ring + (j & 1) * 4 * k;
  }
  __device__ __forceinline__ void next(int j) {   // may run past the stop
    if (j + 1 < cs) {
      stage(ring + ((j + 1) & 1) * 4 * k, lm, k, c_next, n_next);
      st_next = st[(j + 1) * kStep];
    }
    n_after = j + 2 < cs ? n_lanes[c_after] : 0;
    c_far = j + 3 < cs ? si[(j + 3) * kStep] : 0;
  }
  __device__ __forceinline__ void shift() {   // after column j's tests
    st_cur = st_next;
    n_cur = n_next;
    c_next = c_after;
    n_next = n_after;
    c_after = c_far;
  }
};
using Walk = Walker<1>;

// Thread layout and candidates: see sweep_column.cuh.

// K2's resume list, zeroed before pass A: the tiles listed, pass A's
// CTAs finished, the entries pass B's clusters have taken, then an entry
// a tile (tile + 1 once published, 0 before).
constexpr int kListed = 0, kFinished = 1, kTaken = 2, kEntries = 3;
constexpr int kResumeCtas = 4;   // N, RESUME_CTAS in kernels/sweep.py
constexpr long long kWaitCycles = 1LL << 33;   // ~4.5 s at the SM's clock

template <int P>
__global__ void __launch_bounds__(kMaxThreads)
    sweep_closest_kernel(const float* __restrict__ st,
                         const int* __restrict__ si, int cs,
                         const float* __restrict__ rays,
                         const float* __restrict__ t_cap,
                         const float4* __restrict__ lm,
                         const int* __restrict__ n_lanes, int k, float t_min,
                         int budget, int* __restrict__ resume,
                         float* __restrict__ out_t, int* __restrict__ out_tri,
                         float* __restrict__ out_u,
                         float* __restrict__ out_v) {
  // pass B may be scheduled once every CTA of this grid has started
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  extern __shared__ float4 sh[];
  const int nr = blockDim.x / P;
  const int r = threadIdx.x % nr, p = threadIdx.x / nr;
  const int lane = threadIdx.x & 31;
  const int me = p * nr + r;
  const Cands<P> c(sh + 8 * k, nr);   // after the ring's two slots
  const size_t tile = blockIdx.x;
  const float* ray = rays + tile * 6 * nr;
  const float ox = ray[r], oy = ray[nr + r], oz = ray[2 * nr + r];
  const float dx = ray[3 * nr + r], dy = ray[4 * nr + r],
              dz = ray[5 * nr + r];
  float best_t = t_cap[tile * nr + r];
  int best_tri = -1;
  float best_u = 0.0f, best_v = 0.0f;
  seed_closest(c, me, best_t);
  Walk w{st + tile * cs, si + tile * cs, lm, n_lanes, sh, cs, k};
  w.begin();
  bool resumed = false;
  for (int j = 0;; ++j) {
    w.ready();
    __syncthreads();
    // merge column j-1's candidates: this ray's, then the tile's maximum
    const float tile_max =
        merge_closest(c, ((j + 1) & 1) * c.slab, nr, r, lane, best_t,
                      best_tri, best_u, best_v);
    if (j == cs || !(w.st_cur < tile_max)) break;
    if (j == budget) {   // the walk goes on: pass B resumes it at column j
      resumed = true;
      break;
    }
    w.next(j);
    test_closest<true, P>(w.rows(j), w.n_cur, p, ox, oy, oz, dx, dy, dz, t_min,
                       best_t, c, (j & 1) * c.slab + me);
    w.shift();
  }
  if (p == 0) {
    const size_t o = tile * nr + r;
    out_t[o] = best_t;
    out_tri[o] = best_tri;
    out_u[o] = best_u;
    out_v[o] = best_v;
  }
  if (budget >= cs) return;   // no pass B
  if (resumed) {              // the state reaches the card before the entry
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      atomicExch(resume + kEntries + atomicAdd(resume + kListed, 1),
                 (int)tile + 1);
  }
  if (threadIdx.x == 0) {     // after this CTA's entry
    __threadfence();
    atomicAdd(resume + kFinished, 1);
  }
}

// Pass B's next tile for one cluster: the entry it takes, once pass A
// has published it, or -1 once every CTA of pass A has finished and no
// entry is left. Pass A runs beside pass B, so the entry may still be
// coming; a wait past kWaitCycles traps (a fault, not a hang).
__device__ __forceinline__ int take(int* resume, int tiles) {
  volatile int* v = resume;
  const int i = atomicAdd(resume + kTaken, 1);
  const long long t0 = clock64();
  for (;;) {
    if (i < tiles && v[kEntries + i] != 0) break;
    if (v[kFinished] == tiles) {   // every entry is published
      __threadfence();
      if (i >= v[kListed]) return -1;
      break;
    }
    if (clock64() - t0 > kWaitCycles) __trap();
    __nanosleep(200);
  }
  __threadfence();   // the tile's state after its entry
  return v[kEntries + i] - 1;
}

// Pass B's round candidates: ray r's candidate of this CTA's column over
// its P parts (merge_closest's rule: the smaller t, the lower lane on a
// tie), written to dst [4][R] as t, triangle, u, v. A ray without a hit
// in the column gets the seed, the t it entered the round with.
template <int P>
__device__ __forceinline__ void reduce_parts(const Cands<P>& c, int nr, int r,
                                             float* dst) {
  float wt = c.t[r];
  int wl = c.lane[r], wq = 0;
#pragma unroll
  for (int q = 1; q < P; ++q) {
    const float t = c.t[q * nr + r];
    const int l = c.lane[q * nr + r];
    if (t < wt || (t == wt && l < wl)) {
      wt = t;
      wl = l;
      wq = q;
    }
  }
  const int i = wq * nr + r;
  dst[r] = wt;
  dst[nr + r] = __int_as_float(c.tri[i]);
  dst[2 * nr + r] = c.u[i];
  dst[3 * nr + r] = c.v[i];
}

// Pass B: each cluster of N CTAs takes the next tile of the resume list
// and finishes its walk from column `from`, N columns a round: CTA q
// tests column from + N * m + q in round m, seeded with the state at the
// round's start; after one cluster barrier every CTA merges the round's
// N reduced candidates, read from the CTAs' shared memory, in column
// order with the stop rule before each column, so all hold the same
// state; rank 0 writes the answer. Launched as pass A's programmatic
// dependent, it runs beside pass A's last CTAs and takes each tile as
// soon as pass A lists it.
template <int P>
__global__ void __launch_bounds__(kMaxThreads)
    sweep_resume_kernel(const float* __restrict__ st,
                        const int* __restrict__ si, int cs,
                        const float* __restrict__ rays,
                        const float4* __restrict__ lm,
                        const int* __restrict__ n_lanes, int k, float t_min,
                        int from, int tiles, int* resume,
                        float* out_t, int* out_tri, float* out_u,
                        float* out_v) {
  constexpr int N = kResumeCtas;
  constexpr int kLaneRays = kMaxThreads / P / 32;   // the most rays a lane folds
  extern __shared__ float4 sh[];
  __shared__ int taken;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int nr = blockDim.x / P;
  const int r = threadIdx.x % nr, p = threadIdx.x / nr;
  const int lane = threadIdx.x & 31;
  const int me = p * nr + r;
  const Cands<P> c(sh + 8 * k, nr);             // slab 0: this column's parts
  float* red = reinterpret_cast<float*>(c.end());   // [2][4][R] by round parity
  const float* peer[N];
#pragma unroll
  for (int q = 0; q < N; ++q) peer[q] = cluster.map_shared_rank(red, q);
  for (;;) {
    if (rank == 0 && threadIdx.x == 0) taken = take(resume, tiles);
    cluster.sync();
    const int got = *cluster.map_shared_rank(&taken, 0);
    cluster.sync();   // read before rank 0 takes again or leaves; and no
    if (got < 0) break;   // CTA restages while a peer reads its slabs
    const size_t tile = got;
    const float* ray = rays + tile * 6 * nr;
    const float ox = ray[r], oy = ray[nr + r], oz = ray[2 * nr + r];
    const float dx = ray[3 * nr + r], dy = ray[4 * nr + r],
                dz = ray[5 * nr + r];
    const size_t o = tile * nr;
    // pass A's state at column `from`, from L2: pass A wrote it as this
    // grid ran
    float best_t = __ldcg(out_t + o + r);
    int best_tri = __ldcg(out_tri + o + r);
    float best_u = __ldcg(out_u + o + r), best_v = __ldcg(out_v + o + r);
    float lb[kLaneRays];   // the best t of rays lane, lane + 32, ...
    float mx = -INFINITY;
#pragma unroll
    for (int ii = 0; ii < kLaneRays; ++ii) {
      const int rr = lane + 32 * ii;
      lb[ii] = rr < nr ? __ldcg(out_t + o + rr) : -INFINITY;
      mx = fmaxf(mx, lb[ii]);
    }
    float tile_max = warp_max(mx);
    const float* st_t = st + tile * cs;
    const int first = from + rank;
    Walker<N> w{st_t + first, si + tile * cs + first, lm, n_lanes, sh,
                first < cs ? (cs - first + N - 1) / N : 0, k};
    w.begin();
    for (int m = 0, base = from;; ++m, base += N) {
      float stq[N];   // the round's entries, for the stop rule
#pragma unroll
      for (int q = 0; q < N; ++q)
        stq[q] = base + q < cs ? st_t[base + q] : INFINITY;
      w.ready();
      __syncthreads();
      w.next(m);
      test_closest<true, P>(w.rows(m), w.n_cur, p, ox, oy, oz, dx, dy, dz,
                            t_min, best_t, c, me);
      w.shift();
      __syncthreads();
      const int par = (m & 1) * 4 * nr;
      if (p == 0) reduce_parts(c, nr, r, red + par);
      // every CTA's candidates of round m are written and visible; a
      // parity's slab is rewritten in round m + 2, after every thread of
      // the cluster has passed round m + 1's barrier, so has read it
      asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
      asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
      float tq[N], uq[N], vq[N], tl[N][kLaneRays];
      int triq[N];
#pragma unroll
      for (int q = 0; q < N; ++q) {
        const float* s = peer[q] + par;
        tq[q] = s[r];
        triq[q] = __float_as_int(s[nr + r]);
        uq[q] = s[2 * nr + r];
        vq[q] = s[3 * nr + r];
#pragma unroll
        for (int ii = 0; ii < kLaneRays; ++ii)
          tl[q][ii] = lane + 32 * ii < nr ? s[lane + 32 * ii] : -INFINITY;
      }
      // the tiles' largest best t after each column of the round, were
      // the walk to visit it: N reductions side by side
      float tmax[N];
#pragma unroll
      for (int q = 0; q < N; ++q) {
        tmax[q] = -INFINITY;
#pragma unroll
        for (int ii = 0; ii < kLaneRays; ++ii) {
          lb[ii] = fminf(lb[ii], tl[q][ii]);
          tmax[q] = fmaxf(tmax[q], lb[ii]);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int q = 0; q < N; ++q)
          tmax[q] = fmaxf(tmax[q], __shfl_xor_sync(0xffffffffu, tmax[q], off));
      bool done = false;
#pragma unroll
      for (int q = 0; q < N; ++q) {
        // the stop rule on the state after the columns before
        done = done || base + q >= cs ||
               !(stq[q] < (q == 0 ? tile_max : tmax[q - 1]));
        if (!done && tq[q] < best_t) {   // a candidate at or above the
          best_t = tq[q];                // true best t is no candidate of
          best_tri = triq[q];            // the sequential walk
          best_u = uq[q];
          best_v = vq[q];
        }
      }
      if (done) break;
      tile_max = tmax[N - 1];
    }
    if (rank == 0 && p == 0) {
      out_t[o + r] = best_t;
      out_tri[o + r] = best_tri;
      out_u[o + r] = best_u;
      out_v[o + r] = best_v;
    }
    wait_copies();    // the walk's last copy lands before the ring is reused
  }
  // pass A has completed and its writes are visible before this grid is
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// K3/K3b candidates: flag bit 0 = a lane of the part blocks the ray in
// this column, bit 1 = the ray is still open after it (not blocked,
// t_max > 0, no blocking lane in the part); K3b also the part's blocking
// lane with the smallest t (lowest lane on a tie) and its triangle.
template <bool kBlocker, int P>
__global__ void __launch_bounds__(kMaxThreads)
    sweep_occluded_kernel(const float* __restrict__ st,
                          const int* __restrict__ si, int cs,
                          const float* __restrict__ rays,
                          const float* __restrict__ t_max,
                          const float4* __restrict__ lm,
                          const int* __restrict__ n_lanes, int k,
                          int* __restrict__ out_blocked,
                          int* __restrict__ out_btri) {
  extern __shared__ float4 sh[];
  const int nr = blockDim.x / P;
  const int r = threadIdx.x % nr, p = threadIdx.x / nr;
  const int lane = threadIdx.x & 31;
  const int slab = P * nr, me = p * nr + r;
  int* flag = reinterpret_cast<int*>(sh + 8 * k);   // [2][P][R]
  float* ct = reinterpret_cast<float*>(flag + 2 * slab);
  int* cl = reinterpret_cast<int*>(ct + 2 * slab);
  int* ctri = cl + 2 * slab;
  const size_t tile = blockIdx.x;
  const float* ray = rays + tile * 6 * nr;
  const float ox = ray[r], oy = ray[nr + r], oz = ray[2 * nr + r];
  const float dx = ray[3 * nr + r], dy = ray[4 * nr + r],
              dz = ray[5 * nr + r];
  const float tm = t_max[tile * nr + r];
  int blocked = 0;
  int btri = -1;
  flag[slab + me] = tm > 0.0f ? 2 : 0;   // column -1
  if (kBlocker) {
    ct[slab + me] = INFINITY;
    cl[slab + me] = kNone;
  }
  Walk w{st + tile * cs, si + tile * cs, lm, n_lanes, sh, cs, k};
  w.begin();
  for (int j = 0;; ++j) {
    w.ready();
    __syncthreads();
    const int prev = ((j + 1) & 1) * slab;
    int hit = 0;
#pragma unroll
    for (int q = 0; q < P; ++q) hit |= flag[prev + q * nr + r] & 1;
    if (hit && !blocked) {
      blocked = 1;
      if (kBlocker) {
        float wt = ct[prev + r];
        int wl = cl[prev + r], wq = 0;
#pragma unroll
        for (int q = 1; q < P; ++q) {
          const float t = ct[prev + q * nr + r];
          const int l = cl[prev + q * nr + r];
          if (t < wt || (t == wt && l < wl)) {
            wt = t;
            wl = l;
            wq = q;
          }
        }
        btri = ctri[prev + wq * nr + r];
      }
    }
    int any_open = 0;
    for (int rr = lane; rr < nr; rr += 32) {
      int open = 2;
      for (int q = 0; q < P; ++q) open &= flag[prev + q * nr + rr];
      any_open |= open;
    }
    any_open = __any_sync(0xffffffffu, any_open);   // the same in every warp
    if (j == cs || !any_open || !(w.st_cur < INFINITY)) break;
    w.next(j);
    const float4* rows = w.rows(j);
    const bool open = !blocked && tm > 0.0f;   // else settled
    int c_hit = 0, c_l = kNone, c_tri = 0;
    float c_t = INFINITY;
    if (open) {
      for (int l = p; l < w.n_cur; l += P) {
        const float4 a = rows[4 * l];
        const float denom = dot_n(dx, dy, dz, a);
        if (!(denom < -kDetEps)) continue;   // front-facing only
        const float num = a.w - dot_n(ox, oy, oz, a);
        if (!(num < 0.0f)) continue;          // t <= 0
        const float t = num * (1.0f / denom);
        if (!(t > 0.0f && t < INFINITY && t < tm)) continue;
        if (kBlocker && !(t < c_t)) continue;   // the lowest lane wins a tie
        float u, v;
        if (!inside(rows[4 * l + 1], rows[4 * l + 2], ox, oy, oz, dx, dy,
                    dz, t, u, v))
          continue;
        c_hit = 1;
        if (!kBlocker) break;
        c_t = t;
        c_l = l;
        c_tri = (int)rintf(rows[4 * l + 3].x) - 1;
      }
    }
    const int cur = (j & 1) * slab + me;
    flag[cur] = c_hit | ((open && !c_hit) ? 2 : 0);
    if (kBlocker) {
      ct[cur] = c_t;
      cl[cur] = c_l;
      ctri[cur] = c_tri;
    }
    w.shift();
  }
  if (p == 0) {
    out_blocked[tile * nr + r] = blocked;
    if (kBlocker) out_btri[tile * nr + r] = btri;
  }
}

// ring (2 slots of K lane rows) + candidate slabs (2 x P x R words);
// pass B also its round candidates (2 x 4 x R words)
size_t shmem_bytes(int kind, int tile_rays, int k) {
  const size_t ring = 2 * (size_t)k * 16 * sizeof(float);
  if (kind == 1 || kind == 2)
    return ring + 2 * (size_t)parts(tile_rays) * tile_rays * 4 * sizeof(float);
  return ring + cands_bytes(tile_rays) +
         (kind == 3 ? 2 * 4 * (size_t)tile_rays * sizeof(float) : 0);
}

// The instantiation of kernel `kind` (0 K2, 1 K3, 2 K3b, 3 K2's pass B)
// for R rays a tile: P = parts(R); nullptr for a width the kernels do
// not take.
template <int P>
const void* kernel_for(int kind) {
  if (kind == 0) return (const void*)sweep_closest_kernel<P>;
  if (kind == 1) return (const void*)sweep_occluded_kernel<false, P>;
  if (kind == 2) return (const void*)sweep_occluded_kernel<true, P>;
  return (const void*)sweep_resume_kernel<P>;
}

int slot_of(int tile_rays) {   // 0 for P = 4, 1 for P = 2, 2 for P = 1
  switch (tile_rays) {
    case 32: case 64: return 0;
    case 128: return 1;
    case 256: return 2;
    default: return -1;
  }
}

const void* kernel_of(int kind, int tile_rays) {
  switch (slot_of(tile_rays)) {
    case 0: return kernel_for<4>(kind);
    case 1: return kernel_for<2>(kind);
    case 2: return kernel_for<1>(kind);
    default: return nullptr;
  }
}

// Once per kernel instantiation: prefer the largest shared-memory
// carveout (shared memory limits how many blocks share an SM) and allow
// the dynamic shared memory of its largest block (kMaxThreads threads,
// K lanes) beyond the 48 KB default, so a launch makes no attribute call.
int max_k_set[4][3] = {};

cudaError_t prepare(int kind, int tile_rays, int k) {
  const int slot = slot_of(tile_rays);
  const void* fn = kernel_of(kind, tile_rays);
  if (fn == nullptr) return cudaErrorInvalidValue;
  if (k <= max_k_set[kind][slot]) return cudaSuccess;
  const int widest = kMaxThreads / parts(tile_rays);
  const size_t shmem = shmem_bytes(kind, widest, k);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && shmem > 48 * 1024)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)shmem);
  if (e == cudaSuccess) max_k_set[kind][slot] = k;
  return e;
}

// One block a tile, R * parts(R) threads; args as the kernel's parameters.
cudaError_t launch(int kind, int tiles, int tile_rays, int k, void** args,
                   void* stream) {
  cudaError_t e = prepare(kind, tile_rays, k);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernel(kernel_of(kind, tile_rays), dim3(tiles),
                       dim3(tile_rays * parts(tile_rays)), args,
                       shmem_bytes(kind, tile_rays, k), (cudaStream_t)stream);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// Pass B's launch on clusters of kResumeCtas CTAs (attr: the cluster
// dimension); *groups: the clusters the card holds at once
// (cudaOccupancyMaxActiveClusters, kept per width and K).
cudaError_t resume_config(int tile_rays, int k, void* stream,
                          cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                          int* groups) {
  static int held[4][2] = {};   // [width]: K, clusters
  cudaError_t e = prepare(3, tile_rays, k);
  if (e != cudaSuccess) return e;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kResumeCtas;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(kResumeCtas);
  cfg->blockDim = dim3(tile_rays * parts(tile_rays));
  cfg->dynamicSmemBytes = shmem_bytes(3, tile_rays, k);
  cfg->stream = (cudaStream_t)stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  int* h = held[__builtin_ctz(tile_rays) - 5];
  if (h[0] != k) {
    e = cudaOccupancyMaxActiveClusters(&h[1], kernel_of(3, tile_rays), cfg);
    if (e != cudaSuccess) return e;
    h[0] = k;
  }
  *groups = h[1];
  return cudaSuccess;
}

// Pass B on at most as many clusters as the card holds or tiles there
// are, as pass A's programmatic dependent: it may start once every CTA
// of pass A has.
cudaError_t launch_resume(int tiles, int tile_rays, int k, void** args,
                          void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  int groups = 0;
  cudaError_t e = resume_config(tile_rays, k, stream, &cfg, attr, &groups);
  if (e != cudaSuccess) return e;
  groups = groups < tiles ? groups : tiles;
  cfg.gridDim = dim3((groups > 0 ? groups : 1) * kResumeCtas);
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.numAttrs = 2;
  e = cudaLaunchKernelExC(&cfg, kernel_of(3, tile_rays), args);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

// K2: pass A walks every tile up to `budget` columns and lists in
// resume (tiles + kEntries words, zeroed here) the tiles still walking
// there; pass B finishes those. With budget >= cs no walk can pass it:
// pass A alone, resume unused.
extern "C" int pt_sweep_closest(const float* st, const int* si, int tiles,
                                int cs, const float* rays, const float* t_cap,
                                const float* blocks_lm, const int* n_lanes,
                                int k, int tile_rays, float t_min, int budget,
                                int* resume, float* out_t, int* out_tri,
                                float* out_u, float* out_v, void* stream) {
  const float4* lm = (const float4*)blocks_lm;
  const bool split = budget < cs;
  if (split) {
    const cudaError_t e =
        cudaMemsetAsync(resume, 0, (tiles + kEntries) * sizeof(int),
                        (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
  }
  void* args[] = {&st,     &si,     &cs,    &rays,    &t_cap,
                  &lm,     &n_lanes, &k,    &t_min,   &budget,
                  &resume, &out_t,  &out_tri, &out_u, &out_v};
  const cudaError_t e = launch(0, tiles, tile_rays, k, args, stream);
  if (e != cudaSuccess || !split) return (int)e;
  void* args_b[] = {&st,     &si,     &cs,   &rays,  &lm,
                    &n_lanes, &k,     &t_min, &budget, &tiles,
                    &resume,  &out_t, &out_tri, &out_u, &out_v};
  return (int)launch_resume(tiles, tile_rays, k, args_b, stream);
}

extern "C" int pt_sweep_occluded(const float* st, const int* si, int tiles,
                                 int cs, const float* rays,
                                 const float* t_max, const float* blocks_lm,
                                 const int* n_lanes, int k, int tile_rays,
                                 int* out_blocked, void* stream) {
  const float4* lm = (const float4*)blocks_lm;
  int* out_btri = nullptr;
  void* args[] = {&st, &si, &cs, &rays, &t_max, &lm, &n_lanes, &k,
                  &out_blocked, &out_btri};
  return (int)launch(1, tiles, tile_rays, k, args, stream);
}

extern "C" int pt_sweep_occluded_blocker(
    const float* st, const int* si, int tiles, int cs, const float* rays,
    const float* t_max, const float* blocks_lm, const int* n_lanes, int k,
    int tile_rays, int* out_blocked, int* out_btri, void* stream) {
  const float4* lm = (const float4*)blocks_lm;
  void* args[] = {&st, &si, &cs, &rays, &t_max, &lm, &n_lanes, &k,
                  &out_blocked, &out_btri};
  return (int)launch(2, tiles, tile_rays, k, args, stream);
}

// Registers a thread, local (spill) bytes a thread and resident blocks an
// SM of kernel `kind` (0 K2, 1 K3, 2 K3b, 3 K2's pass B) for tile_rays
// rays a tile and K lanes, as the launches above configure it;
// *threads = threads a block; *groups = the clusters pass B's launch
// takes at most (0 for the other kinds).
extern "C" int pt_sweep_info(int kind, int tile_rays, int k, int* regs,
                             int* local_bytes, int* blocks_per_sm,
                             int* threads, int* groups) {
  const void* fn = kernel_of(kind, tile_rays);
  const size_t shmem = shmem_bytes(kind, tile_rays, k);
  cudaError_t e = prepare(kind, tile_rays, k);
  cudaFuncAttributes a;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, fn);
  *groups = 0;
  if (e == cudaSuccess && kind == 3) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    e = resume_config(tile_rays, k, nullptr, &cfg, &attr, groups);
  }
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *threads = tile_rays * parts(tile_rays);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fn, *threads, shmem);
}
