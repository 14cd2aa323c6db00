// K2's column: the helpers and the per-column body of the closest sweep,
// shared by csrc/sweep.cu (K2, and K3/K3b's helpers) and csrc/probes.cu
// (P3, which times K2's column on a synthetic schedule). Whatever K2's
// column does, P3's full variant does with the same code, so P3 keeps
// measuring K2's cost a column when K2 changes. Every function inlines;
// the definitions have internal linkage in each source that includes them.
//
// Thread layout: blockDim = R * P with P = parts(R) threads a ray (4 for
// R = 32 and 64; 2 for R = 128 and 1 for R = 256, so a block never holds
// more than kMaxThreads); thread i tests ray r = i % R with part p = i / R,
// i.e. lanes p, p + P, ... of each column. R is a multiple of 32, so a
// warp holds one part of 32 rays and every lane row it reads is a
// broadcast.
//
// Candidates of a column (shared, two slabs by column parity, each
// [P][R]): a part's first minimum among its lanes that hit with t < the
// ray's best t, seeded with the best t and lane kNone. After the barrier
// every thread of a ray merges the P candidates in the same order -
// smaller t wins, the lower lane on a tie - which is the first minimum
// over the column in lane order, whatever P is.
//
// Exact rejects before the reciprocal: a hit needs t > t_min >= 0, and
// t = (d - n.o) * (1/denom) rounded is > 0 only if d - n.o and denom have
// one strict sign. A lane that survives computes t, then u and v, in the
// plain versions' order of roundings, and is rejected on the t range
// before u and v are formed.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kDetEps = 1e-12f;
constexpr int kParts = 4;              // threads a ray at R <= 64
constexpr int kMaxThreads = 256;       // threads a block: R * parts(R)
constexpr int kNone = 0x7fffffff;      // candidate lane of "no hit"

// Threads a ray (lane parts) for R rays a tile (32, 64, 128 or 256).
constexpr int parts(int tile_rays) {
  return tile_rays <= kMaxThreads / kParts ? kParts : kMaxThreads / tile_rays;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// n16 16-byte cp.async copies from src to shared dst by every thread of
// the block; commit() closes the group
__device__ __forceinline__ void copy16(float4* dst,
                                       const float4* __restrict__ src,
                                       int n16) {
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(dst);
  for (int i = threadIdx.x; i < n16; i += blockDim.x)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     base + 16u * (uint32_t)i),
                 "l"(src + i)
                 : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait for this thread's copies; a barrier must follow
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

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

// The closest sweep's candidate slabs, [2][P][R] words of t, lane,
// triangle, u and v, laid out from `base` in shared memory.
template <int P>
struct Cands {
  float* t;
  int* lane;
  int* tri;
  float* u;
  float* v;
  int slab;   // P * R

  __device__ __forceinline__ Cands(float4* base, int nr)
      : t(reinterpret_cast<float*>(base)),
        lane(reinterpret_cast<int*>(t + 2 * P * nr)),
        tri(lane + 2 * P * nr),
        u(reinterpret_cast<float*>(tri + 2 * P * nr)),
        v(u + 2 * P * nr),
        slab(P * nr) {}
  // first word past the slabs
  __device__ __forceinline__ void* end() const { return v + 2 * slab; }
};

// Shared bytes of the candidate slabs for R rays a tile
constexpr size_t cands_bytes(int tile_rays) {
  return 2 * (size_t)parts(tile_rays) * tile_rays * 5 * sizeof(float);
}

// Column -1: no candidate, the ray's best t seeded into slot `me` of the
// odd slab.
template <int P>
__device__ __forceinline__ void seed_closest(const Cands<P>& c, int me,
                                             float best_t) {
  c.t[c.slab + me] = best_t;
  c.lane[c.slab + me] = kNone;
}

// Merge the candidates of the column before (slab offset prev) into ray
// r's best hit; returns the largest candidate t over the tile's R rays,
// the same in every warp, so each computes the stop rule without a
// second barrier.
template <int P>
__device__ __forceinline__ float merge_closest(const Cands<P>& c, int prev,
                                               int nr, int r, int lane,
                                               float& best_t, int& best_tri,
                                               float& best_u, float& best_v) {
  float tq[P];
  int lq[P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    tq[q] = c.t[prev + q * nr + r];
    lq[q] = c.lane[prev + q * nr + r];
  }
  float wt = tq[0];
  int wl = lq[0], wq = 0;
#pragma unroll
  for (int q = 1; q < P; ++q)
    if (tq[q] < wt || (tq[q] == wt && lq[q] < wl)) {
      wt = tq[q];
      wl = lq[q];
      wq = q;
    }
  if (wl != kNone) {
    const int i = prev + wq * nr + r;
    best_t = wt;
    best_tri = c.tri[i];
    best_u = c.u[i];
    best_v = c.v[i];
  }
  float m = -INFINITY;
  for (int rr = lane; rr < nr; rr += 32) {
    float t = c.t[prev + rr];
    for (int q = 1; q < P; ++q) t = fminf(t, c.t[prev + q * nr + rr]);
    m = fmaxf(m, t);
  }
  return warp_max(m);
}

// Part p's lane tests of one column for ray (o, d): lanes p, p + P, ...
// below n of `rows` (lane-major, four float4 a lane: n, d | r1, c1 |
// r2, c2 | id + 1), the first minimum with t_min < t < best_t, written as
// the ray's candidate at slab slot cur. kIdFilter skips lanes whose id
// row marks a pad (id < 0), as K2 does; P3, like the JAX probe, keeps
// every lane.
template <bool kIdFilter, int P>
__device__ __forceinline__ void test_closest(const float4* rows, int n, int p,
                                             float ox, float oy, float oz,
                                             float dx, float dy, float dz,
                                             float t_min, float best_t,
                                             const Cands<P>& c, int cur) {
  float c_t = best_t, c_u = 0.0f, c_v = 0.0f;
  int c_l = kNone, c_tri = 0;
  if (best_t > t_min) {   // else no t with t_min < t < best_t
    for (int l = p; l < n; l += P) {
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
      if (!inside(rows[4 * l + 1], rows[4 * l + 2], ox, oy, oz, dx, dy, dz,
                  t, u, v))
        continue;
      const int id = (int)rintf(rows[4 * l + 3].x) - 1;
      if (kIdFilter && id < 0) continue;
      c_t = t;
      c_l = l;
      c_tri = id;
      c_u = u;
      c_v = v;
    }
  }
  c.t[cur] = c_t;
  c.lane[cur] = c_l;
  c.tri[cur] = c_tri;
  c.u[cur] = c_u;
  c.v[cur] = c_v;
}

}  // namespace
