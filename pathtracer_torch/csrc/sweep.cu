// K2 closest sweep, K3 occlusion sweep and K3b occlusion sweep with
// blocker hints, over the per-tile cluster schedule.
//
// Replaces pathtracer/kernels/pallas_sweep.py:_sweep_kernel (through
// sweep_closest) and :_occl_kernel (through sweep_occluded, K3 without and
// K3b with want_blocker), with the Baldwin-Weber lane test of _bw_lane.
//
// Layout: one block per tile, four threads per ray (R = 64 rays, 256
// threads; R = 32 also runs): the ray's four threads test interleaved
// quarters of each
// column's lanes. The block walks its tile's near-to-far schedule st/si
// [tiles, Cs] with a two-slot ring of staged clusters in shared memory:
// while the rays test column j's cluster, column j+1's is in flight
// (16-byte cp.async).
//
// Why four threads a ray: a tile's walk is sequential (whether column
// j+1 is visited depends on column j's hits), and the longest walks set
// a launch's time: on the headline's bounce batches a few tiles walk
// 150-260 columns against a median of 20-30, and a chunk's 8 longest
// tiles alone take most of its time (tools/sweep_tail.py). With one
// thread a ray such a tile ran on 2 warps; four parts give it 8 warps of
// one SM. More parts, two lanes interleaved per iteration, or a
// branch-free lane body were not faster on the card: the long walk is
// then bound by its lane tests at one SM's issue rate.
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
// longest tiles' walks, each on one SM; beyond the needed tests it runs
// those of rays whose tile walks on for other rays. The ~2.8k-cluster
// table of the headline scene is ~23 MB and stays in the 50 MB L2.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kDetEps = 1e-12f;
constexpr int kParts = 4;              // threads a ray (lane parts)
constexpr int kMaxThreads = 256;       // R * kParts, so R <= 64
constexpr int kNone = 0x7fffffff;      // candidate lane of "no hit"

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Stage the first n lane rows of cluster cid (n x 64 B) into ring slot
// dst: 16-byte cp.async by every thread, committed as one group.
__device__ __forceinline__ void stage(float4* dst,
                                      const float4* __restrict__ lm, int k,
                                      int cid, int n) {
  const float4* src = lm + (size_t)cid * k * 4;
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(dst);
  for (int i = threadIdx.x; i < 4 * n; i += blockDim.x)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     base + 16u * (uint32_t)i),
                 "l"(src + i)
                 : "memory");
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The tile's schedule walk: column j's cluster (n_cur real lanes) lies in
// ring slot j & 1 once ready() returned; next(j), called when column j is
// visited, puts column j+1's cluster (c_next, n_next) in flight into the
// other slot and reads ahead what the next columns need - st[j+1], the
// lane count of column j+2's cluster c_after, the cluster of column j+3 -
// so that no load is waited for where it is read.
struct Walk {
  const float* st;
  const int* si;
  const float4* lm;
  const int* n_lanes;
  float4* ring;
  int cs, k;
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
      c_next = si[1];
      n_next = n_lanes[c_next];
    }
    if (cs > 2) c_after = si[2];
  }
  // wait for this thread's copies of column j; a barrier must follow
  __device__ __forceinline__ void ready() const {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
  __device__ __forceinline__ const float4* rows(int j) const {
    return ring + (j & 1) * 4 * k;
  }
  __device__ __forceinline__ void next(int j) {   // may run past the stop
    if (j + 1 < cs) {
      stage(ring + ((j + 1) & 1) * 4 * k, lm, k, c_next, n_next);
      st_next = st[j + 1];
    }
    n_after = j + 2 < cs ? n_lanes[c_after] : 0;
    c_far = j + 3 < cs ? si[j + 3] : 0;
  }
  __device__ __forceinline__ void shift() {   // after column j's tests
    st_cur = st_next;
    n_cur = n_next;
    c_next = c_after;
    n_next = n_after;
    c_after = c_far;
  }
};

// The plane part of the Baldwin-Weber test of lane row a = (n, d):
// denom = dir.n and the numerator of t, d - o.n.
__device__ __forceinline__ float dot_n(float x, float y, float z,
                                       const float4 a) {
  return x * a.x + y * a.y + z * a.z;
}

// u and v of the hit point o + t dir from rows b = (r1, c1), c = (r2, c2)
__device__ __forceinline__ bool inside(const float4 b, const float4 c,
                                       float ox, float oy, float oz,
                                       float dx, float dy, float dz, float t,
                                       float& u, float& v) {
  const float hx = ox + t * dx;
  const float hy = oy + t * dy;
  const float hz = oz + t * dz;
  u = b.x * hx + b.y * hy + b.z * hz + b.w;
  v = c.x * hx + c.y * hy + c.z * hz + c.w;
  return u >= 0.0f && v >= 0.0f && u + v <= 1.0f;
}

// Thread layout of both kernels: blockDim = R * kParts; thread i tests
// ray r = i % R with part p = i / R, i.e. lanes p, p + kParts, ... of
// each column. R is a multiple of 32, so a warp holds one part of 32
// rays and every lane row it reads is a broadcast.
//
// Candidates of a column (shared, two slabs by column parity, each
// [kParts][R]): a part's first minimum among its lanes that hit with
// t < the ray's best t, seeded with the best t and lane kNone. After the
// barrier every thread of a ray merges the kParts candidates in the same
// order - smaller t wins, the lower lane on a tie - which is the first
// minimum over the column in lane order.

__global__ void __launch_bounds__(kMaxThreads)
    sweep_closest_kernel(const float* __restrict__ st,
                         const int* __restrict__ si, int cs,
                         const float* __restrict__ rays,
                         const float* __restrict__ t_cap,
                         const float4* __restrict__ lm,
                         const int* __restrict__ n_lanes, int k, float t_min,
                         float* __restrict__ out_t, int* __restrict__ out_tri,
                         float* __restrict__ out_u,
                         float* __restrict__ out_v) {
  extern __shared__ float4 sh[];
  const int nr = blockDim.x / kParts;
  const int r = threadIdx.x % nr, p = threadIdx.x / nr;
  const int lane = threadIdx.x & 31;
  const int slab = kParts * nr, me = p * nr + r;
  float* ct = reinterpret_cast<float*>(sh + 8 * k);   // [2][kParts][R]
  int* cl = reinterpret_cast<int*>(ct + 2 * slab);
  int* ctri = cl + 2 * slab;
  float* cu = reinterpret_cast<float*>(ctri + 2 * slab);
  float* cv = cu + 2 * slab;
  const size_t tile = blockIdx.x;
  const float* ray = rays + tile * 6 * nr;
  const float ox = ray[r], oy = ray[nr + r], oz = ray[2 * nr + r];
  const float dx = ray[3 * nr + r], dy = ray[4 * nr + r],
              dz = ray[5 * nr + r];
  float best_t = t_cap[tile * nr + r];
  int best_tri = -1;
  float best_u = 0.0f, best_v = 0.0f;
  ct[slab + me] = best_t;   // column -1: no candidate
  cl[slab + me] = kNone;
  Walk w{st + tile * cs, si + tile * cs, lm, n_lanes, sh, cs, k};
  w.begin();
  for (int j = 0;; ++j) {
    w.ready();
    __syncthreads();
    // merge column j-1's candidates: this ray's, then the tile's maximum
    const int prev = ((j + 1) & 1) * slab;
    float tq[kParts];
    int lq[kParts];
#pragma unroll
    for (int q = 0; q < kParts; ++q) {
      tq[q] = ct[prev + q * nr + r];
      lq[q] = cl[prev + q * nr + r];
    }
    float wt = tq[0];
    int wl = lq[0], wq = 0;
#pragma unroll
    for (int q = 1; q < kParts; ++q)
      if (tq[q] < wt || (tq[q] == wt && lq[q] < wl)) {
        wt = tq[q];
        wl = lq[q];
        wq = q;
      }
    if (wl != kNone) {
      const int i = prev + wq * nr + r;
      best_t = wt;
      best_tri = ctri[i];
      best_u = cu[i];
      best_v = cv[i];
    }
    float m = -INFINITY;
    for (int rr = lane; rr < nr; rr += 32) {
      float t = ct[prev + rr];
      for (int q = 1; q < kParts; ++q) t = fminf(t, ct[prev + q * nr + rr]);
      m = fmaxf(m, t);
    }
    const float tile_max = warp_max(m);   // the same in every warp
    if (j == cs || !(w.st_cur < tile_max)) break;
    w.next(j);
    const float4* rows = w.rows(j);
    float c_t = best_t, c_u = 0.0f, c_v = 0.0f;
    int c_l = kNone, c_tri = 0;
    if (best_t > t_min) {   // else no t with t_min < t < best_t
      for (int l = p; l < w.n_cur; l += kParts) {
        const float4 a = rows[4 * l];
        const float denom = dot_n(dx, dy, dz, a);
        const float num = a.w - dot_n(ox, oy, oz, a);
        // t > t_min >= 0 needs |denom| > eps and num of denom's sign
        if (!(fabsf(denom) > kDetEps &&
              (denom > 0.0f ? num > 0.0f : num < 0.0f)))
          continue;
        const float t = num * (1.0f / denom);
        if (!(t > t_min && t < c_t)) continue;
        float u, v;
        if (!inside(rows[4 * l + 1], rows[4 * l + 2], ox, oy, oz, dx, dy,
                    dz, t, u, v))
          continue;
        const int id = (int)rintf(rows[4 * l + 3].x) - 1;
        if (id < 0) continue;
        c_t = t;
        c_l = l;
        c_tri = id;
        c_u = u;
        c_v = v;
      }
    }
    const int cur = (j & 1) * slab + me;
    ct[cur] = c_t;
    cl[cur] = c_l;
    ctri[cur] = c_tri;
    cu[cur] = c_u;
    cv[cur] = c_v;
    w.shift();
  }
  if (p == 0) {
    const size_t o = tile * nr + r;
    out_t[o] = best_t;
    out_tri[o] = best_tri;
    out_u[o] = best_u;
    out_v[o] = best_v;
  }
}

// K3/K3b candidates: flag bit 0 = a lane of the part blocks the ray in
// this column, bit 1 = the ray is still open after it (not blocked,
// t_max > 0, no blocking lane in the part); K3b also the part's blocking
// lane with the smallest t (lowest lane on a tie) and its triangle.
template <bool kBlocker>
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
  const int nr = blockDim.x / kParts;
  const int r = threadIdx.x % nr, p = threadIdx.x / nr;
  const int lane = threadIdx.x & 31;
  const int slab = kParts * nr, me = p * nr + r;
  int* flag = reinterpret_cast<int*>(sh + 8 * k);   // [2][kParts][R]
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
    for (int q = 0; q < kParts; ++q) hit |= flag[prev + q * nr + r] & 1;
    if (hit && !blocked) {
      blocked = 1;
      if (kBlocker) {
        float wt = ct[prev + r];
        int wl = cl[prev + r], wq = 0;
#pragma unroll
        for (int q = 1; q < kParts; ++q) {
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
      for (int q = 0; q < kParts; ++q) open &= flag[prev + q * nr + rr];
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
      for (int l = p; l < w.n_cur; l += kParts) {
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

// ring (2 slots of K lane rows) + candidate slabs (2 x kParts x R words)
size_t shmem_bytes(int kind, int tile_rays, int k) {
  const int words = kind == 0 ? 5 : 4;
  return 2 * (size_t)k * 16 * sizeof(float) +
         2 * (size_t)kParts * tile_rays * words * sizeof(float);
}

const void* kernel_of(int kind) {
  if (kind == 0) return (const void*)sweep_closest_kernel;
  if (kind == 1) return (const void*)sweep_occluded_kernel<false>;
  return (const void*)sweep_occluded_kernel<true>;
}

// Once per kernel: prefer the largest shared-memory carveout (shared
// memory limits how many blocks share an SM) and allow the dynamic
// shared memory of the largest block (R = 64, K lanes) beyond the 48 KB
// default, so a launch makes no attribute call.
int max_k_set[3] = {0, 0, 0};

cudaError_t prepare(int kind, int k) {
  if (k <= max_k_set[kind]) return cudaSuccess;
  const void* fn = kernel_of(kind);
  const size_t shmem = shmem_bytes(kind, kMaxThreads / kParts, k);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && shmem > 48 * 1024)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)shmem);
  if (e == cudaSuccess) max_k_set[kind] = k;
  return e;
}

}  // namespace

extern "C" int pt_sweep_closest(const float* st, const int* si, int tiles,
                                int cs, const float* rays, const float* t_cap,
                                const float* blocks_lm, const int* n_lanes,
                                int k, int tile_rays, float t_min,
                                float* out_t, int* out_tri, float* out_u,
                                float* out_v, void* stream) {
  const size_t shmem = shmem_bytes(0, tile_rays, k);
  cudaError_t e = prepare(0, k);
  if (e != cudaSuccess) return (int)e;
  sweep_closest_kernel<<<tiles, tile_rays * kParts, shmem,
                         (cudaStream_t)stream>>>(
      st, si, cs, rays, t_cap, (const float4*)blocks_lm, n_lanes, k, t_min,
      out_t, out_tri, out_u, out_v);
  return (int)cudaGetLastError();
}

extern "C" int pt_sweep_occluded(const float* st, const int* si, int tiles,
                                 int cs, const float* rays,
                                 const float* t_max, const float* blocks_lm,
                                 const int* n_lanes, int k, int tile_rays,
                                 int* out_blocked, void* stream) {
  const size_t shmem = shmem_bytes(1, tile_rays, k);
  cudaError_t e = prepare(1, k);
  if (e != cudaSuccess) return (int)e;
  sweep_occluded_kernel<false>
      <<<tiles, tile_rays * kParts, shmem, (cudaStream_t)stream>>>(
          st, si, cs, rays, t_max, (const float4*)blocks_lm, n_lanes, k,
          out_blocked, nullptr);
  return (int)cudaGetLastError();
}

extern "C" int pt_sweep_occluded_blocker(
    const float* st, const int* si, int tiles, int cs, const float* rays,
    const float* t_max, const float* blocks_lm, const int* n_lanes, int k,
    int tile_rays, int* out_blocked, int* out_btri, void* stream) {
  const size_t shmem = shmem_bytes(2, tile_rays, k);
  cudaError_t e = prepare(2, k);
  if (e != cudaSuccess) return (int)e;
  sweep_occluded_kernel<true>
      <<<tiles, tile_rays * kParts, shmem, (cudaStream_t)stream>>>(
          st, si, cs, rays, t_max, (const float4*)blocks_lm, n_lanes, k,
          out_blocked, out_btri);
  return (int)cudaGetLastError();
}

// Registers a thread, local (spill) bytes a thread and resident blocks an
// SM of kernel `kind` (0 K2, 1 K3, 2 K3b) for tile_rays rays a tile and
// K lanes, as the launches above configure it; *threads = threads a block.
extern "C" int pt_sweep_info(int kind, int tile_rays, int k, int* regs,
                             int* local_bytes, int* blocks_per_sm,
                             int* threads) {
  const void* fn = kernel_of(kind);
  const size_t shmem = shmem_bytes(kind, tile_rays, k);
  cudaError_t e = prepare(kind, k);
  cudaFuncAttributes a;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *threads = tile_rays * kParts;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fn, tile_rays * kParts, shmem);
}
