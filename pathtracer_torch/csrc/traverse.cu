// K5 closest-hit and K6 any-hit traversal of the threaded LBVH.
//
// Replaces pathtracer/kernels/traverse.py:_intersect_chunk (K5) and
// :_occluded_chunk (K6). Those are XLA code, not Pallas: a
// lax.while_loop that advances every ray of a chunk one node a step. A
// PyTorch loop of that shape would synchronise the host at every step,
// so on the card the walk is one kernel.
//
// Layout: one thread a ray. Each walks the threaded tree of
// accel/lbvh.py with no stack: a box hit on an internal node goes to
// node + 1 (its first child in DFS preorder); a leaf, or a box miss, goes
// to the node's miss link; -1 ends the walk.
//   nodes f32[n_nodes, 8]: lo.xyz, hi.xyz, miss_link, tri_id (the two
//     links as int32 bits), 32 B a node, read as two float4 loads.
//   tris  f32[T, 9]: v0, e1 = v1 - v0, e2 = v2 - v0 (Moller-Trumbore).
//   o, d  f32[N, 3]; t_max f32[N].
// K5 keeps the nearest (t, tri, u, v) with t_min < t < best_t (best_t
// seeded from t_max, replaced only by a strictly smaller t, so the first
// of equal-t triangles in DFS order wins) and writes t = inf on a miss.
// K6 stops a ray at its first front-facing triangle (dot(d, e1 x e2) < 0,
// the reference's backface skip) with 0 < t < t_max and writes 1, else 0.
//
// Built with -fmad=false: every expression is a rounded product and a
// rounded sum in the plain versions' order (kernels/traverse.py), 1/x is
// the correctly rounded reciprocal, and min/max propagate NaN as
// torch.minimum/maximum do, so kernel and plain version agree bit for
// bit.
//
// What bounds it on an H100: neither bytes nor FP32 rate but the walk
// itself. Each step is a dependent chain (node load, slab test, branch),
// rays of a warp diverge as soon as their paths part, and a warp runs as
// long as its longest ray. Simple and right first: no stack, no wide
// nodes, no treelets, no ray reordering.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

// torch.minimum / torch.maximum: NaN if either operand is NaN
__device__ __forceinline__ float tmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float tmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float safe_inv(float d) {
  const float tiny = 1e-20f;
  const float ds = fabsf(d) < tiny ? (d < 0.0f ? -tiny : tiny) : d;
  return 1.0f / ds;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

__device__ __forceinline__ Ray load_ray(const float* o, const float* d,
                                        int r) {
  Ray ray;
  ray.ox = o[3 * r];
  ray.oy = o[3 * r + 1];
  ray.oz = o[3 * r + 2];
  ray.dx = d[3 * r];
  ray.dy = d[3 * r + 1];
  ray.dz = d[3 * r + 2];
  ray.ix = safe_inv(ray.dx);
  ray.iy = safe_inv(ray.dy);
  ray.iz = safe_inv(ray.dz);
  return ray;
}

// Slab test of node `node`: (t_near, t_far) and its two links.
__device__ __forceinline__ void slab(const float4* __restrict__ nodes,
                                     int node, const Ray& r, float* t_near,
                                     float* t_far, int* miss, int* tri) {
  const float4 a = __ldg(&nodes[2 * node]);      // lo.xyz, hi.x
  const float4 b = __ldg(&nodes[2 * node + 1]);  // hi.yz, miss, tri
  const float t1x = (a.x - r.ox) * r.ix;
  const float t1y = (a.y - r.oy) * r.iy;
  const float t1z = (a.z - r.oz) * r.iz;
  const float t2x = (a.w - r.ox) * r.ix;
  const float t2y = (b.x - r.oy) * r.iy;
  const float t2z = (b.y - r.oz) * r.iz;
  *t_near = tmax(tmax(tmin(t1x, t2x), tmin(t1y, t2y)), tmin(t1z, t2z));
  *t_far = tmin(tmin(tmax(t1x, t2x), tmax(t1y, t2y)), tmax(t1z, t2z));
  *miss = __float_as_int(b.z);
  *tri = __float_as_int(b.w);
}

// Moller-Trumbore against row `tri` of tris, in _mt_packed's order.
// Returns the hit flag; writes t, u, v and the front-facing flag.
__device__ __forceinline__ bool moller_trumbore(
    const float* __restrict__ tris, int tri, const Ray& r, float t_lo,
    float t_hi, float* t_out, float* u_out, float* v_out, bool* front) {
  const float* row = tris + 9 * (size_t)tri;
  const float v0x = __ldg(row), v0y = __ldg(row + 1), v0z = __ldg(row + 2);
  const float e1x = __ldg(row + 3), e1y = __ldg(row + 4),
              e1z = __ldg(row + 5);
  const float e2x = __ldg(row + 6), e2y = __ldg(row + 7),
              e2z = __ldg(row + 8);
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = (e1x * px + e1y * py) + e1z * pz;
  const bool ok_det = fabsf(det) > 1e-12f;
  const float inv_det = ok_det ? 1.0f / det : 0.0f;
  const float tx = r.ox - v0x, ty = r.oy - v0y, tz = r.oz - v0z;
  const float u = ((tx * px + ty * py) + tz * pz) * inv_det;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float v = ((r.dx * qx + r.dy * qy) + r.dz * qz) * inv_det;
  const float t = ((e2x * qx + e2y * qy) + e2z * qz) * inv_det;
  const float gx = e1y * e2z - e1z * e2y;
  const float gy = e1z * e2x - e1x * e2z;
  const float gz = e1x * e2y - e1y * e2x;
  *front = ((r.dx * gx + r.dy * gy) + r.dz * gz) < 0.0f;
  *t_out = t;
  *u_out = u;
  *v_out = v;
  return ok_det && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > t_lo &&
         t < t_hi;
}

__global__ void __launch_bounds__(kThreads)
    bvh_closest_kernel(const float4* __restrict__ nodes,
                       const float* __restrict__ tris,
                       const float* __restrict__ o,
                       const float* __restrict__ d, int n_rays, float t_min,
                       const float* __restrict__ t_max,
                       float* __restrict__ out_t, int* __restrict__ out_tri,
                       float* __restrict__ out_u,
                       float* __restrict__ out_v) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const Ray ray = load_ray(o, d, r);
  float best_t = t_max[r], best_u = 0.0f, best_v = 0.0f;
  int best_tri = -1;
  int node = 0;
  while (node >= 0) {
    float t_near, t_far;
    int miss, tri;
    slab(nodes, node, ray, &t_near, &t_far, &miss, &tri);
    const bool box_hit =
        t_near <= t_far && t_far >= t_min && t_near <= best_t;
    if (box_hit && tri >= 0) {
      float t, u, v;
      bool front;
      if (moller_trumbore(tris, tri, ray, t_min, best_t, &t, &u, &v,
                          &front) &&
          t < best_t) {
        best_t = t;
        best_tri = tri;
        best_u = u;
        best_v = v;
      }
    }
    node = (box_hit && tri < 0) ? node + 1 : miss;
  }
  out_t[r] = best_tri >= 0 ? best_t : INFINITY;
  out_tri[r] = best_tri;
  out_u[r] = best_u;
  out_v[r] = best_v;
}

__global__ void __launch_bounds__(kThreads)
    bvh_occluded_kernel(const float4* __restrict__ nodes,
                        const float* __restrict__ tris,
                        const float* __restrict__ o,
                        const float* __restrict__ d, int n_rays,
                        const float* __restrict__ t_max,
                        uint8_t* __restrict__ out_blocked) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const Ray ray = load_ray(o, d, r);
  const float tm = t_max[r];
  bool blocked = false;
  int node = 0;
  while (node >= 0) {
    float t_near, t_far;
    int miss, tri;
    slab(nodes, node, ray, &t_near, &t_far, &miss, &tri);
    const bool box_hit = t_near <= t_far && t_far >= 0.0f && t_near <= tm;
    if (box_hit && tri >= 0) {
      float t, u, v;
      bool front;
      if (moller_trumbore(tris, tri, ray, 0.0f, INFINITY, &t, &u, &v,
                          &front) &&
          front && t < tm) {
        blocked = true;
        break;  // early out
      }
    }
    node = (box_hit && tri < 0) ? node + 1 : miss;
  }
  out_blocked[r] = blocked ? 1 : 0;
}

inline unsigned blocks_for(int n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int pt_bvh_closest(const float* nodes, const float* tris,
                              const float* o, const float* d, int n_rays,
                              float t_min, const float* t_max, float* out_t,
                              int* out_tri, float* out_u, float* out_v,
                              void* stream) {
  bvh_closest_kernel<<<blocks_for(n_rays), kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const float4*)nodes, tris, o, d, n_rays, t_min, t_max, out_t, out_tri,
      out_u, out_v);
  return (int)cudaGetLastError();
}

extern "C" int pt_bvh_occluded(const float* nodes, const float* tris,
                               const float* o, const float* d, int n_rays,
                               const float* t_max, uint8_t* out_blocked,
                               void* stream) {
  bvh_occluded_kernel<<<blocks_for(n_rays), kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const float4*)nodes, tris, o, d, n_rays, t_max, out_blocked);
  return (int)cudaGetLastError();
}
