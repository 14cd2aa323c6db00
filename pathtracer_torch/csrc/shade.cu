// K10: one bounce's shading, from the closest hit to the shadow rays, and
// its resolve once the shadow queries are answered.
//
// Replaces, on the card, the eager chain of integrator/path.py that runs
// between the two traversal layers: trace_paths' `segment` after the
// intersect call (sky on a miss with its env MIS weight, the texture-
// filter draw, fetch_surface, the emitter hit with its MIS weight) and
// `bounce` up to its shadow queries and after them (alpha passthrough,
// the dielectric branch, light selection and the shadow ray, the env-NEE
// draw and its shadow ray, BSDF lobe choice, sampling, pdf and eval, the
// continuation, Russian roulette and the throughput cut-off). Its JAX
// counterpart, pathtracer/integrator/path.py:686 `segment` and :795
// `bounce`, is XLA code, not Pallas. The plain chain runs a few hundred
// full-width eager ops a bounce, each reading and writing every lane of
// the wavefront, dead ones included.
//
// Layout: one thread a lane, a grid-stride loop. A lane that was not
// active on entry parks its two shadow rays, clears its pending flags and
// leaves. A live lane does the chain in registers and writes only what
// the next stage reads:
//   the state in place: o, d, throughput, radiance, active, prev_pdf;
//   the tri-NEE shadow ray (s_orig, s_dir, s_tmax) and the env-NEE one
//     (e_orig, e_dir; its t_max is the wrapper's constant 1e18), each
//     parked at origin 1e30 and direction 1.0 where its query is not made,
//     as the plain chain parks them, so the packet layer's chunk_live and
//     chunking see the same lanes;
//   both NEE contributions, pending: throughput x contribution, and a flag
//     byte (bit 0 tri, bit 1 env) saying which were made;
//   the exact ray count (lanes active on entry, shading lanes with a tri
//     NEE query, env queries traced) added to the int64 counter with one
//     integer atomic a warp, so the count costs no host sync.
// The resolve kernel (shade_resolve_kernel) then adds the pending tri
// term, then the env term, to radiance where the lane's query was made
// and not blocked. With the next bounce's sky or emission term first,
// radiance takes its terms in the plain chain's order, bounce by bounce.
// The last segment runs K10 with `last` set: the sky and emission terms
// and the count only.
//
// Numerics: built with -fmad=false (cuda_build.py), every expression is a
// rounded product and a rounded sum in the plain chain's order. Torch's
// CUDA eager ops call sqrtf, rsqrtf, sinf, cosf, atan2f, acosf, floorf
// and powf (x ** 2.2, x ** 5; ** 2 is x * x), and so does this kernel; a
// tensor divided by a Python scalar is, in torch's CUDA eager op, the
// product with the scalar's float reciprocal, and is written so here;
// clamp returns NaN inputs unchanged as torch's does; searchsorted is
// torch's lower-bound loop, the env row search envlight's fixed-step one.
// Every uniform is PCG4D inline (pcg4d.cuh, K9's hash), keyed as
// sampling/rng.uniform4 keys it.
//
// Left to the plain chain (integrator/shade.py kernel_shades), as no cell
// runs them: cfg.reference_quirks (a second estimator), sampler="sobol"
// (a 32-step scrambled Sobol draw a uniform), sky="hosek" (the
// Hosek-Wilkie model), the primed bounce 0 (its shadow queries verify
// blocker hints between the set-up and the contribution) and the bounce
// that fills the G-buffer (it reads the whole surface). CPU tensors always
// take the plain chain.
//
// What bounds it on an H100: bytes. A live lane reads its state and hit
// (~100 B), its surface row (96-128 B), material row (64 B), one
// composite texel (24 B) or a few u8 texels, and its light row (~70 B),
// and writes the next state, two shadow rays and two pending terms
// (~160 B): about 450 B, so 8.3M live lanes need ~3.7 GB, ~1.1 ms at
// 3.35 TB/s. A dead lane costs its flag, the park writes and one byte.
// The design keeps every intermediate in registers; the gathers are
// scattered, so what the kernel reaches is set by how many loads are in
// flight, not by the instruction rate.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pcg4d.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;

// Python's M_PI (float64) as torch casts it to float32, and the float32
// reciprocals torch's eager division by a Python scalar multiplies by.
constexpr float kPi = (float)3.14159265358979323846;
constexpr float kInvPi = 1.0f / kPi;
constexpr float kTwoPi = (float)(2.0 * 3.14159265358979323846);
constexpr float kInvTwoPi = 1.0f / kTwoPi;
constexpr float kInv255 = (float)(1.0 / 255.0);
constexpr float kEps = 1e-5f;       // vmath.EPS, mf.EPS
constexpr float kPark = 1e30f;

// salts of sampling/rng.py
constexpr uint32_t kSaltAlpha = 1, kSaltDielectric = 2, kSaltLightSelect = 3,
                   kSaltLightUv = 4, kSaltBsdfLobe = 5, kSaltBsdfUv = 6,
                   kSaltRr = 7, kSaltEnvSelect = 8, kSaltTexFilter = 10,
                   kSaltEnvRr = 11;

enum TexKind { kTexNone = 0, kTexComposite = 1, kTexStack = 2,
               kTexBilinear = 3 };
enum SkyKind { kSkyBlack = 0, kSkyGradient = 1, kSkyEnvmap = 2 };

// Mirrors integrator/shade.py ShadeParams field for field.
struct ShadeParams {
  float* o;
  float* d;
  float* thr;
  float* rad;
  uint8_t* active;
  float* prev_pdf;
  const void* pix;
  const void* samp;
  const float* hit_t;
  const int32_t* hit_tri;
  const float* hit_u;
  const float* hit_v;
  const float* surf_rows;
  const float* mat_rows;
  const long long* tex_comp;
  const int32_t* tex_comp_wh;
  const uint8_t* textures;
  const int32_t* tex_wh;
  const float* light_cdf;
  const float* light_v0;
  const float* light_v1;
  const float* light_v2;
  const float* light_n;
  const float* light_le;
  const float* light_area;
  const float* light_pdf;
  const float* envmap;
  const float* env_blocks;
  const float* env_mcdf;
  const float* env_ccdf;
  const float* env_pdf;
  const float* env_table;
  const long long* env_s0;
  float* s_orig;
  float* s_dir;
  float* s_tmax;
  float* e_orig;
  float* e_dir;
  float* pend_tri;
  float* pend_env;
  uint8_t* pend_flags;
  unsigned long long* rays;
  long long n;
  long long surf_cols;
  long long n_lights;
  long long tex_th, tex_tw;
  long long comp_ch, comp_cw;
  long long env_h, env_w;
  long long row_iters;
  long long width, cell, cells_x, s_win;
  int pix64, samp64;
  unsigned depth_salt, seed;
  int last, tex_kind, sky_kind, env_mis, tri_nee, env_nee, rr_on;
  float sky_gain, emission_gain, shadow_eps, t_min;
  float rr_lo, rr_hi, cutoff, env_shadow_rr;
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) {
  V3 r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}
__device__ __forceinline__ V3 ld3(const float* p, long long i) {
  return v3(p[3 * i], p[3 * i + 1], p[3 * i + 2]);
}
__device__ __forceinline__ void st3(float* p, long long i, V3 a) {
  p[3 * i] = a.x;
  p[3 * i + 1] = a.y;
  p[3 * i + 2] = a.z;
}
__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return v3(a.x + b.x, a.y + b.y, a.z + b.z);
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return v3(a.x - b.x, a.y - b.y, a.z - b.z);
}
__device__ __forceinline__ V3 mul(V3 a, V3 b) {
  return v3(a.x * b.x, a.y * b.y, a.z * b.z);
}
__device__ __forceinline__ V3 scale(V3 a, float s) {
  return v3(a.x * s, a.y * s, a.z * s);
}
__device__ __forceinline__ V3 neg(V3 a) { return v3(-a.x, -a.y, -a.z); }
__device__ __forceinline__ V3 sel(bool c, V3 a, V3 b) { return c ? a : b; }

// vmath.dot: ((a0*b0 + a1*b1) + a2*b2)
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return (a.x * b.x + a.y * b.y) + a.z * b.z;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x);
}

// torch.clamp on CUDA: a NaN input passes through
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// vmath.normalize: a * rsqrt(clamp(dot(a, a), min=1e-20))
__device__ __forceinline__ V3 normalize(V3 a) {
  return scale(a, rsqrtf(clamp_min(dot(a, a), 1e-20f)));
}
// vmath.reflect: i - 2 * dot(n, i) * n
__device__ __forceinline__ V3 reflect(V3 i, V3 n) {
  return sub(i, scale(n, 2.0f * dot(n, i)));
}
// vmath.maxc (amax over 3, NaN propagating)
__device__ __forceinline__ float max3(V3 a) {
  float m = a.x;
  if (isnan(m)) return m;
  if (isnan(a.y) || a.y > m) m = a.y;
  if (isnan(m)) return m;
  if (isnan(a.z) || a.z > m) m = a.z;
  return m;
}

// torch.remainder of int64 (floor-mod)
__device__ __forceinline__ long long floor_mod(long long a, long long b) {
  long long r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

// torch.searchsorted(right=False): torch's lower-bound loop
__device__ __forceinline__ long long lower_bound(const float* bd,
                                                 long long end, float val) {
  long long start = 0;
  while (start < end) {
    const long long mid = start + ((end - start) >> 1);
    if (!(bd[mid] >= val)) {
      start = mid + 1;
    } else {
      end = mid;
    }
  }
  return start;
}

__device__ __forceinline__ float power_heuristic(float a, float b) {
  const float a2 = a * a;
  return a2 / clamp_min(a2 + b * b, 1e-20f);
}

// ---------------------------------------------------------------- BSDF
// bsdf/microfacet.py, term for term

__device__ __forceinline__ float rough_alpha(float r) {
  return clamp_min(r * r, 0.001f);
}
__device__ __forceinline__ float ggx_d(float ndh, float alpha) {
  const float a2 = alpha * alpha;
  const float ndh2 = ndh * ndh;
  const float denom = ndh2 * (a2 - 1.0f) + 1.0f;
  return a2 / (kPi * denom * denom);
}
__device__ __forceinline__ float smith_g1(float x, float alpha) {
  const float k = (alpha * alpha) * 0.5f;
  return x / (x * (1.0f - k) + k);
}
__device__ __forceinline__ float lobe_prob(float metallic, float rough) {
  return clamp(metallic + (1.0f - rough) * 0.5f, 0.0f, 1.0f);
}

struct Mat {
  V3 n, albedo;
  float rough, metallic;
};

// eval_brdf(n, v, l, albedo, metallic, roughness)
__device__ V3 eval_brdf(const Mat& m, V3 v, V3 l) {
  const float ndl = clamp_min(dot(m.n, l), 0.0f);
  const float ndv = clamp_min(dot(m.n, v), 0.0f);
  const bool valid = (ndl > 0.0f) && (ndv > 0.0f);
  const V3 h = normalize(add(v, l));
  const float ndh = clamp_min(dot(m.n, h), 0.0f);
  const float vdh = clamp_min(dot(v, h), 0.0f);
  const float om = 1.0f - m.metallic;
  const float f0m = 0.04f * om;
  const V3 f0 = v3(f0m + m.albedo.x * m.metallic,
                   f0m + m.albedo.y * m.metallic,
                   f0m + m.albedo.z * m.metallic);
  const float p5 = powf(1.0f - vdh, 5.0f);
  const V3 fr = v3(f0.x + (1.0f - f0.x) * p5, f0.y + (1.0f - f0.y) * p5,
                   f0.z + (1.0f - f0.z) * p5);
  const float alpha = rough_alpha(m.rough);
  const float d = ggx_d(ndh, alpha);
  const float g = smith_g1(ndv, alpha) * smith_g1(ndl, alpha);
  const float s = (d * g) / (4.0f * ndv * ndl + 1e-6f);
  const V3 spec = scale(fr, s);
  const V3 diff = v3((om * m.albedo.x) * kInvPi, (om * m.albedo.y) * kInvPi,
                     (om * m.albedo.z) * kInvPi);
  return valid ? add(diff, spec) : v3(0.0f, 0.0f, 0.0f);
}

// pdf_bsdf(n, v, l, metallic, roughness)
__device__ float pdf_bsdf(const Mat& m, V3 v, V3 l) {
  const float p_spec = lobe_prob(m.metallic, m.rough);
  const V3 h = normalize(add(v, l));
  const float ndh = clamp_min(dot(m.n, h), 0.0f);
  const float vdh = clamp_min(dot(v, h), kEps);
  const float ps = (ggx_d(ndh, rough_alpha(m.rough)) * ndh) / (4.0f * vdh);
  const float pd = clamp_min(dot(m.n, l), 0.0f) * kInvPi;
  return clamp_min(p_spec * ps + (1.0f - p_spec) * pd, 1e-6f);
}

// vmath.onb
__device__ __forceinline__ void onb(V3 n, V3* t, V3* b) {
  const bool cond = fabsf(n.x) > fabsf(n.y);
  const V3 ta = v3(n.z, 0.0f, -n.x);
  const V3 tb = v3(0.0f, -n.z, n.y);
  *t = normalize(cond ? ta : tb);
  *b = cross(n, *t);
}

__device__ V3 sample_ggx(V3 n, V3 v, float rough, float u1, float u2) {
  const float a = rough_alpha(rough);
  const float phi = kTwoPi * u1;
  const float cos_t =
      sqrtf(clamp_min((1.0f - u2) / (1.0f + (a * a - 1.0f) * u2), 0.0f));
  const float sin_t = sqrtf(clamp_min(1.0f - cos_t * cos_t, 0.0f));
  const float hx = cosf(phi) * sin_t;
  const float hy = sinf(phi) * sin_t;
  V3 t, b;
  onb(n, &t, &b);
  const V3 h = normalize(add(add(scale(t, hx), scale(b, hy)), scale(n, cos_t)));
  return normalize(reflect(neg(v), h));
}

__device__ V3 sample_cosine(V3 n, float u1, float u2) {
  const float phi = kTwoPi * u1;
  const float r = sqrtf(u2);
  const float x = r * cosf(phi);
  const float y = r * sinf(phi);
  const float z = sqrtf(clamp_min(1.0f - u2, 0.0f));
  V3 t, b;
  onb(n, &t, &b);
  return normalize(add(add(scale(t, x), scale(b, y)), scale(n, z)));
}

// ---------------------------------------------------------------- env map

// envlight.env_texel + env_pdf
__device__ float env_pdf_at(const ShadeParams& p, V3 d) {
  const float theta = acosf(clamp(d.y, -1.0f, 1.0f));
  const float phi = atan2f(d.z, d.x);
  int r = (int)(theta * kInvPi * (float)p.env_h);
  int c = (int)((phi * kInvTwoPi + 0.5f) * (float)p.env_w);
  r = min(max(r, 0), (int)p.env_h - 1);
  c = min(max(c, 0), (int)p.env_w - 1);
  return p.env_pdf[(long long)r * p.env_w + c];
}

// sky.envmap_radiance, through the 2x2 footprint rows when blocks != null
__device__ V3 env_radiance(const ShadeParams& p, V3 d, const float* blocks) {
  const long long h = p.env_h, w = p.env_w;
  const float u =
      (atan2f(d.z, d.x) * kInvTwoPi + 0.5f) * (float)w - 0.5f;
  const float v = (acosf(clamp(d.y, -1.0f, 1.0f)) * kInvPi) * (float)h - 0.5f;
  const float x0f = floorf(u);
  const float y0f = floorf(v);
  const float fx = u - x0f;
  const float fy = v - y0f;
  long long x0 = (long long)x0f;
  long long y0 = (long long)y0f;
  const long long x1 = floor_mod(x0 + 1, w);
  x0 = floor_mod(x0, w);
  const long long y1 = min(max(y0 + 1, 0LL), h - 1);
  y0 = min(max(y0, 0LL), h - 1);
  V3 t00, t01, t10, t11;
  if (blocks != nullptr) {
    const float* row = blocks + (y0 * w + x0) * 12;
    t00 = v3(row[0], row[1], row[2]);
    t01 = v3(row[3], row[4], row[5]);
    t10 = v3(row[6], row[7], row[8]);
    t11 = v3(row[9], row[10], row[11]);
  } else {
    t00 = ld3(p.envmap, y0 * w + x0);
    t01 = ld3(p.envmap, y0 * w + x1);
    t10 = ld3(p.envmap, y1 * w + x0);
    t11 = ld3(p.envmap, y1 * w + x1);
  }
  const float gx = 1.0f - fx, gy = 1.0f - fy;
  const V3 a = add(scale(t00, gx), scale(t01, fx));
  const V3 b = add(scale(t10, gx), scale(t11, fx));
  return add(scale(a, gy), scale(b, fy));
}

// envlight.sample_env, then env_pdf and the unfiltered-block radiance, as
// path._env_draw draws a lane's env-NEE direction
__device__ void env_draw(const ShadeParams& p, Pcg4 u, V3* l_dir,
                         float* p_env, V3* le) {
  const long long h = p.env_h, w = p.env_w;
  const float u1 = to_unit(u.x), u2 = to_unit(u.y), u3 = to_unit(u.z),
              u4 = to_unit(u.w);
  long long r = lower_bound(p.env_mcdf, h, u1);
  r = min(max(r, 0LL), h - 1);
  // envlight._row_searchsorted: fixed steps over row r
  const float* row = p.env_ccdf + r * w;
  long long lo = 0, hi = w;
  for (long long it = 0; it < p.row_iters; ++it) {
    const bool open = lo < hi;
    const long long mid = (lo + hi) / 2;
    const bool right = open && (row[min(mid, w - 1)] < u2);
    if (right) {
      lo = mid + 1;
    } else if (open) {
      hi = mid;
    }
  }
  const long long c = min(max(lo, 0LL), w - 1);
  const float theta = (((float)r + u3) * (1.0f / (float)h)) * kPi;
  const float phi = (((float)c + u4) * (1.0f / (float)w) - 0.5f) * kTwoPi;
  const float st = sinf(theta);
  *l_dir = v3(st * cosf(phi), cosf(theta), st * sinf(phi));
  *p_env = env_pdf_at(p, *l_dir);
  *le = env_radiance(p, *l_dir, nullptr);
}

// ---------------------------------------------------------------- lanes

__device__ __forceinline__ uint32_t load_id(const void* ptr, int is64,
                                            long long i) {
  if (is64) return (uint32_t)((const long long*)ptr)[i];
  return (uint32_t)((const int32_t*)ptr)[i];
}

struct Key {
  uint32_t pix, samp, depth_salt, seed;
  __device__ __forceinline__ Pcg4 draw(uint32_t salt) const {
    return pcg4d(pix, samp, depth_salt + salt, seed);
  }
};

// one u8 texel of the texture stack, as floats in [0, 1]
__device__ __forceinline__ float4 texel(const ShadeParams& p, long long tid,
                                        long long y, long long x) {
  const uint8_t* q = p.textures + ((tid * p.tex_th + y) * p.tex_tw + x) * 4;
  return make_float4((float)q[0] * kInv255, (float)q[1] * kInv255,
                     (float)q[2] * kInv255, (float)q[3] * kInv255);
}

// path._sample_texture: one stochastic tap (tex_u) or the bilinear blend
__device__ float4 sample_texture(const ShadeParams& p, int tex_id, float u,
                                 float v, float ux, float uy) {
  const long long tid = tex_id < 0 ? 0 : tex_id;
  const long long twi = p.tex_wh[2 * tid], thi = p.tex_wh[2 * tid + 1];
  const float x = u * (float)twi - 0.5f;
  const float y = v * (float)thi - 0.5f;
  if (p.tex_kind == kTexStack) {
    const long long xi = floor_mod((long long)floorf(x + ux), twi);
    const long long yi = floor_mod((long long)floorf(y + uy), thi);
    return texel(p, tid, yi, xi);
  }
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float fx = x - x0, fy = y - y0;
  const long long x0i = floor_mod((long long)x0, twi);
  const long long y0i = floor_mod((long long)y0, thi);
  const long long x1i = floor_mod(x0i + 1, twi);
  const long long y1i = floor_mod(y0i + 1, thi);
  const float4 a0 = texel(p, tid, y0i, x0i), a1 = texel(p, tid, y0i, x1i);
  const float4 b0 = texel(p, tid, y1i, x0i), b1 = texel(p, tid, y1i, x1i);
  const float gx = 1.0f - fx, gy = 1.0f - fy;
  const float4 a = make_float4(a0.x * gx + a1.x * fx, a0.y * gx + a1.y * fx,
                               a0.z * gx + a1.z * fx, a0.w * gx + a1.w * fx);
  const float4 b = make_float4(b0.x * gx + b1.x * fx, b0.y * gx + b1.y * fx,
                               b0.z * gx + b1.z * fx, b0.w * gx + b1.w * fx);
  return make_float4(a.x * gy + b.x * fy, a.y * gy + b.y * fy,
                     a.z * gy + b.z * fy, a.w * gy + b.w * fy);
}

// path._normal_map (Gram-Schmidt TBN)
__device__ V3 normal_map(const float* row, float w0, float w1, float w2,
                         V3 normal, V3 nm) {
  const V3 t0 = v3(row[20], row[21], row[22]);
  const V3 t1 = v3(row[23], row[24], row[25]);
  const V3 t2 = v3(row[26], row[27], row[28]);
  const V3 tangent =
      normalize(add(add(scale(t0, w0), scale(t1, w1)), scale(t2, w2)));
  const V3 t_ortho =
      normalize(sub(tangent, scale(normal, dot(normal, tangent))));
  const V3 b = cross(normal, t_ortho);
  return normalize(add(add(scale(t_ortho, nm.x), scale(b, nm.y)),
                       scale(normal, nm.z)));
}

__device__ __forceinline__ float unpack8(long long word, int i) {
  return (float)((word >> (8 * i)) & 0xFF) * kInv255;
}

__device__ __forceinline__ void park(const ShadeParams& p, long long i) {
  if (p.tri_nee) {
    st3(p.s_orig, i, v3(kPark, kPark, kPark));
    st3(p.s_dir, i, v3(1.0f, 1.0f, 1.0f));
    p.s_tmax[i] = 0.0f;
  }
  if (p.env_nee) {
    st3(p.e_orig, i, v3(kPark, kPark, kPark));
    st3(p.e_dir, i, v3(1.0f, 1.0f, 1.0f));
  }
  p.pend_flags[i] = 0;
}

// One lane; returns the rays it adds to the counter.
__device__ unsigned shade_lane(const ShadeParams& p, long long i) {
  if (!p.active[i]) {
    if (!p.last) park(p, i);
    return 0;
  }
  unsigned rays = 1;
  const int tri = p.hit_tri[i];
  const V3 d = ld3(p.d, i);
  const V3 thr = ld3(p.thr, i);
  V3 rad = ld3(p.rad, i);
  const float prev_pdf = p.prev_pdf[i];

  if (tri < 0) {
    // the miss shader, MIS-weighted against env NEE (env_mis: the env
    // map is importance-sampled, even where skip_nee drops the draws)
    if (p.sky_kind != kSkyBlack) {
      V3 sky;
      if (p.sky_kind == kSkyGradient) {
        const float t = clamp(0.5f * (d.y + 1.0f), 0.0f, 1.0f);
        const float m = (1.0f - t) * (1.0f - t);
        const float om = 1.0f - m;
        sky = v3((0.6f * om + 0.02f * m) * p.sky_gain,
                 (0.7f * om + 0.02f * m) * p.sky_gain,
                 (0.9f * om + 0.05f * m) * p.sky_gain);
      } else {
        sky = env_radiance(p, d, p.env_blocks);
      }
      if (p.env_mis) {
        const float w_sky = isinf(prev_pdf)
                                ? 1.0f
                                : power_heuristic(prev_pdf, env_pdf_at(p, d));
        sky = scale(sky, w_sky);
      }
      st3(p.rad, i, add(rad, mul(thr, sky)));
    }
    if (!p.last) {
      p.active[i] = 0;
      p.prev_pdf[i] = INFINITY;
      park(p, i);
    }
    return rays;
  }

  const Key key = {load_id(p.pix, p.pix64, i), load_id(p.samp, p.samp64, i),
                   p.depth_salt, p.seed};
  const float t = p.hit_t[i];
  const float* row = p.surf_rows + (long long)tri * p.surf_cols;
  const long long mid = (long long)rintf(row[18]) - 1;
  const float* mrow = p.mat_rows + mid * 16;
  const V3 m_albedo = v3(mrow[0], mrow[1], mrow[2]);
  const float lpa = row[19];

  // the emitter hit, MIS-weighted against light sampling
  {
    const V3 gn = v3(row[15], row[16], row[17]);
    const V3 emission = mul(v3(mrow[3], mrow[4], mrow[5]), m_albedo);
    const float cos_l = clamp_min(dot(gn, neg(d)), 0.0f);
    const float pdf_light = lpa * t * t / clamp_min(cos_l, kEps);
    const float w_emit = (isinf(prev_pdf) || lpa <= 0.0f)
                             ? 1.0f
                             : power_heuristic(prev_pdf, pdf_light);
    const V3 e = scale(scale(mul(thr, emission), p.emission_gain), w_emit);
    rad = add(rad, e);
    st3(p.rad, i, rad);
  }
  if (p.last) return rays;

  // fetch_surface
  const V3 o = ld3(p.o, i);
  const float w1 = p.hit_u[i];
  const float w2 = p.hit_v[i];
  const float w0 = 1.0f - w1 - w2;
  const float t_safe = isfinite(t) ? t : 1.0f;
  const V3 position = add(o, scale(d, t_safe));
  Mat m;
  m.n = normalize(add(add(scale(v3(row[0], row[1], row[2]), w0),
                          scale(v3(row[3], row[4], row[5]), w1)),
                      scale(v3(row[6], row[7], row[8]), w2)));
  m.albedo = m_albedo;
  float rough = mrow[6];
  float metallic = mrow[7];
  const float ior = mrow[8];
  float alpha = mrow[9];
  const long long mat_type = (long long)rintf(mrow[10]) - 1;
  if (p.tex_kind != kTexNone) {
    const int atex = (int)rintf(mrow[11]) - 1;
    const int mrtex = (int)rintf(mrow[12]) - 1;
    const int ntex = (int)rintf(mrow[13]) - 1;
    const float u = (row[9] * w0 + row[11] * w1) + row[13] * w2;
    const float v = (row[10] * w0 + row[12] * w1) + row[14] * w2;
    float ux = 0.0f, uy = 0.0f;
    if (p.tex_kind != kTexBilinear) {
      const Pcg4 tu = key.draw(kSaltTexFilter);
      ux = to_unit(tu.x);
      uy = to_unit(tu.y);
    }
    V3 nm;
    if (p.tex_kind == kTexComposite) {
      const long long twi = p.tex_comp_wh[2 * mid];
      const long long thi = p.tex_comp_wh[2 * mid + 1];
      const float x = u * (float)twi - 0.5f;
      const float y = v * (float)thi - 0.5f;
      const long long xi = floor_mod((long long)floorf(x + ux), twi);
      const long long yi = floor_mod((long long)floorf(y + uy), thi);
      const long long* w3 =
          p.tex_comp + ((mid * p.comp_ch + yi) * p.comp_cw + xi) * 3;
      const long long wa = w3[0], wm = w3[1], wn = w3[2];
      if (atex >= 0) {
        m.albedo = v3(powf(unpack8(wa, 0), 2.2f), powf(unpack8(wa, 1), 2.2f),
                      powf(unpack8(wa, 2), 2.2f));
        alpha = alpha * unpack8(wa, 3);
      }
      if (mrtex >= 0) {
        rough = rough * unpack8(wm, 1);
        metallic = metallic * unpack8(wm, 2);
      }
      nm = v3(unpack8(wn, 0) * 2.0f - 1.0f, unpack8(wn, 1) * 2.0f - 1.0f,
              unpack8(wn, 2) * 2.0f - 1.0f);
    } else {
      if (atex >= 0) {
        const float4 a = sample_texture(p, atex, u, v, ux, uy);
        m.albedo = v3(powf(clamp_min(a.x, 0.0f), 2.2f),
                      powf(clamp_min(a.y, 0.0f), 2.2f),
                      powf(clamp_min(a.z, 0.0f), 2.2f));
        alpha = alpha * a.w;
      }
      if (mrtex >= 0) {
        const float4 mr = sample_texture(p, mrtex, u, v, ux, uy);
        rough = rough * mr.y;
        metallic = metallic * mr.z;
      }
      nm = v3(0.0f, 0.0f, 0.0f);
      if (ntex >= 0) {
        const float4 q = sample_texture(p, ntex, u, v, ux, uy);
        nm = v3(q.x * 2.0f - 1.0f, q.y * 2.0f - 1.0f, q.z * 2.0f - 1.0f);
      }
    }
    if (ntex >= 0) m.n = normal_map(row, w0, w1, w2, m.n, nm);
  }
  m.rough = clamp(rough, 0.01f, 1.0f);
  m.metallic = clamp(metallic, 0.0f, 1.0f);
  alpha = clamp(alpha, 0.0f, 1.0f);
  const V3 view = neg(d);

  // alpha stochastic transparency
  const float u_alpha = to_unit(key.draw(kSaltAlpha).x);
  const bool passthrough = (alpha < 0.99f) && (u_alpha > alpha);

  // dielectric
  const bool is_diel = !passthrough && mat_type == 2;
  V3 d_diel = v3(0.0f, 0.0f, 0.0f);
  if (is_diel) {
    const float cosi = dot(d, m.n);
    const bool entering = cosi <= 0.0f;
    const float eta = entering ? 1.0f / ior : ior;
    const V3 n_eff = entering ? m.n : neg(m.n);
    const float c2 = -dot(d, n_eff);
    const float k = 1.0f - eta * eta * (1.0f - c2 * c2);
    const bool tir = k < 0.0f;
    const float sk = sqrtf(clamp_min(k, 0.0f));
    V3 refr = add(scale(d, eta), scale(n_eff, eta * c2 - sk));
    if (tir) refr = v3(0.0f, 0.0f, 0.0f);
    const float refl_prob =
        clamp(0.04f + 0.96f * powf(1.0f - fabsf(cosi), 5.0f), 0.0f, 1.0f);
    const float u_d = to_unit(key.draw(kSaltDielectric).x);
    const bool take_refl = tir || (u_d < refl_prob);
    d_diel = take_refl ? reflect(d, m.n) : refr;
  }
  const bool shade = !passthrough && !is_diel;
  uint8_t flags = 0;

  // NEE to emissive triangles
  if (p.tri_nee) {
    bool valid = false;
    V3 s_orig = v3(kPark, kPark, kPark), s_dir = v3(1.0f, 1.0f, 1.0f);
    float s_tmax = 0.0f;
    if (shade) {
      rays += 1;
      const float u_sel = to_unit(key.draw(kSaltLightSelect).x);
      long long li = lower_bound(p.light_cdf, p.n_lights, u_sel);
      li = min(max(li, 0LL), p.n_lights - 1);
      const V3 lv0 = ld3(p.light_v0, li), lv1 = ld3(p.light_v1, li),
               lv2 = ld3(p.light_v2, li), ln = ld3(p.light_n, li);
      const Pcg4 ruv = key.draw(kSaltLightUv);
      const float r1 = to_unit(ruv.x), r2 = to_unit(ruv.y);
      const float sr1 = sqrtf(r1);
      const float b0 = 1.0f - sr1;
      const float b1 = r2 * sr1;
      const float b2 = 1.0f - b0 - b1;
      const V3 pl = add(add(scale(lv0, b0), scale(lv1, b1)), scale(lv2, b2));
      const float p_a = p.light_pdf[li] / clamp_min(p.light_area[li], kEps);
      const V3 to_light = sub(pl, position);
      const float dist2 = clamp_min(dot(to_light, to_light), kEps);
      const V3 l_dir = scale(to_light, rsqrtf(dist2));
      const float ndl = clamp_min(dot(m.n, l_dir), 0.0f);
      const float nl_dot = clamp_min(dot(ln, neg(l_dir)), 0.0f);
      const bool geo_ok = (ndl > 0.0f) && (nl_dot > 0.0f);
      const V3 so = add(position, scale(m.n, p.shadow_eps));
      const V3 seg = sub(pl, so);
      const float seg_len = sqrtf(clamp_min(dot(seg, seg), 1e-20f));
      s_tmax = seg_len * 0.999f;
      valid = geo_ok;
      if (valid) {
        s_orig = so;
        s_dir = v3(seg.x / seg_len, seg.y / seg_len, seg.z / seg_len);
        const V3 f = eval_brdf(m, view, l_dir);
        const float p_omega = p_a * dist2 / clamp_min(nl_dot, kEps);
        const float w = power_heuristic(p_omega, pdf_bsdf(m, view, l_dir));
        const float g = ndl * nl_dot / dist2;
        const float gq = g / clamp_min(p_a, 1e-12f);
        const V3 le = ld3(p.light_le, li);
        const V3 contrib =
            scale(scale(mul(f, scale(le, p.emission_gain)), gq), w);
        st3(p.pend_tri, i, mul(thr, contrib));
        flags |= 1;
      }
    }
    st3(p.s_orig, i, s_orig);
    st3(p.s_dir, i, s_dir);
    p.s_tmax[i] = s_tmax;
  }

  // NEE to the env map
  if (p.env_nee) {
    V3 e_orig = v3(kPark, kPark, kPark), e_dir = v3(1.0f, 1.0f, 1.0f);
    if (shade) {
      V3 l_dir, le;
      float p_env;
      if (p.cell > 1) {
        const long long pix = key.pix;
        const long long cell_id = (pix / p.width) / p.cell * p.cells_x +
                                  (pix % p.width) / p.cell;
        const long long samp = p.samp64 ? ((const long long*)p.samp)[i]
                                        : ((const int32_t*)p.samp)[i];
        const long long slot = min(samp - *p.env_s0, p.s_win - 1);
        const float* r = p.env_table + (cell_id * p.s_win + slot) * 7;
        l_dir = v3(r[0], r[1], r[2]);
        p_env = r[3];
        le = v3(r[4], r[5], r[6]);
      } else {
        env_draw(p, key.draw(kSaltEnvSelect), &l_dir, &p_env, &le);
      }
      const float ndl = clamp_min(dot(m.n, l_dir), 0.0f);
      bool valid = (ndl > 0.0f) && (p_env > 0.0f);
      float inv_q = 1.0f;
      if (p.env_shadow_rr > 0.0f) {
        const float lum = (0.2126f * thr.x + 0.7152f * thr.y) + 0.0722f * thr.z;
        const float q = clamp(p.env_shadow_rr * lum, 0.125f, 1.0f);
        const float u_rr = to_unit(key.draw(kSaltEnvRr).x);
        valid = valid && (u_rr < q);
        inv_q = 1.0f / q;
      }
      if (valid) {
        rays += 1;
        e_orig = add(position, scale(m.n, p.shadow_eps));
        e_dir = l_dir;
        const V3 f = eval_brdf(m, view, l_dir);
        const float w = power_heuristic(p_env, pdf_bsdf(m, view, l_dir));
        const float s = ndl * w * inv_q / clamp_min(p_env, 1e-12f);
        st3(p.pend_env, i, mul(thr, scale(mul(f, le), s)));
        flags |= 2;
      }
    }
    st3(p.e_orig, i, e_orig);
    st3(p.e_dir, i, e_dir);
  }
  p.pend_flags[i] = flags;

  // the continuation: passthrough, dielectric, or a BSDF sample
  V3 new_d = d;
  V3 thr_out = thr;
  float pdf_out = INFINITY;
  bool alive = true;
  if (is_diel) {
    new_d = d_diel;
  } else if (shade) {
    const float u_lobe = to_unit(key.draw(kSaltBsdfLobe).x);
    const Pcg4 uv = key.draw(kSaltBsdfUv);
    const float u1 = to_unit(uv.x), u2 = to_unit(uv.y);
    const bool spec = u_lobe < lobe_prob(m.metallic, m.rough);
    const V3 l_new = spec ? sample_ggx(m.n, view, m.rough, u1, u2)
                          : sample_cosine(m.n, u1, u2);
    const float ndl = clamp_min(dot(m.n, l_new), 0.0f);
    const float mix_pdf = pdf_bsdf(m, view, l_new);
    const V3 f = eval_brdf(m, view, l_new);
    const float s = ndl / mix_pdf;
    thr_out = scale(mul(thr, f), s);
    pdf_out = mix_pdf;
    new_d = l_new;
    alive = ndl > 0.0f;
    // Russian roulette
    if (alive && p.rr_on) {
      const float q = clamp(max3(thr_out), p.rr_lo, p.rr_hi);
      const float u_rr = to_unit(key.draw(kSaltRr).x);
      if (u_rr <= q) {
        thr_out = v3(thr_out.x / q, thr_out.y / q, thr_out.z / q);
      } else {
        alive = false;
      }
    }
  }
  alive = alive && (max3(thr_out) >= p.cutoff);
  st3(p.o, i, add(position, scale(new_d, p.t_min)));
  st3(p.d, i, new_d);
  st3(p.thr, i, thr_out);
  p.prev_pdf[i] = pdf_out;
  p.active[i] = alive ? 1 : 0;
  return rays;
}

__global__ void __launch_bounds__(kThreads)
    shade_kernel(const ShadeParams p) {
  const long long step = (long long)gridDim.x * kThreads;
  unsigned rays = 0;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < p.n;
       i += step) {
    rays += shade_lane(p, i);
  }
  for (int off = 16; off > 0; off >>= 1)
    rays += __shfl_down_sync(0xFFFFFFFFu, rays, off);
  if ((threadIdx.x & 31) == 0 && rays != 0)
    atomicAdd(p.rays, (unsigned long long)rays);
}

// Adds the pending NEE terms of the lanes whose query was made and not
// blocked: the tri term, then the env term (path.bounce's order).
__global__ void __launch_bounds__(kThreads)
    shade_resolve_kernel(long long n, const uint8_t* __restrict__ flags,
                         const uint8_t* __restrict__ blocked_tri,
                         const uint8_t* __restrict__ blocked_env,
                         const float* __restrict__ pend_tri,
                         const float* __restrict__ pend_env,
                         float* __restrict__ rad) {
  const long long step = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += step) {
    const uint8_t f = flags[i];
    if (f == 0) continue;
    V3 r = ld3(rad, i);
    if ((f & 1) && !blocked_tri[i]) r = add(r, ld3(pend_tri, i));
    if ((f & 2) && !blocked_env[i]) r = add(r, ld3(pend_env, i));
    st3(rad, i, r);
  }
}

unsigned grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return (unsigned)(blocks < 1 ? 1 : blocks);
}

}  // namespace

extern "C" int pt_shade_params_size() { return (int)sizeof(ShadeParams); }

// The launch arguments arrive as a pointer to integrator/shade.py's
// ShadeParams (a type of this file alone, so the exported signature
// names none).
extern "C" int pt_shade(const void* params, void* stream) {
  const ShadeParams& p = *(const ShadeParams*)params;
  shade_kernel<<<grid_for(p.n), kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int pt_shade_resolve(long long n, const uint8_t* flags,
                                const uint8_t* blocked_tri,
                                const uint8_t* blocked_env,
                                const float* pend_tri, const float* pend_env,
                                float* rad, void* stream) {
  shade_resolve_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      n, flags, blocked_tri, blocked_env, pend_tri, pend_env, rad);
  return (int)cudaGetLastError();
}
