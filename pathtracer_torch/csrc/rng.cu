// K9: one PCG4D draw of four uniforms a lane.
//
// Replaces the eager chain of sampling/rng.py on the card (the
// counterpart of pathtracer/sampling/rng.py:pcg4d / uniform4, which are
// XLA code in the JAX package, not Pallas): _key stacks the four u32 key
// words (pixel, sample, depth * 12 + salt, seed), pcg4d hashes them and
// _to_unit keeps each word's top 24 bits scaled by 2^-24. CPU torch has
// no u32 `+` or `>>`, so the plain version emulates u32 arithmetic in
// int64 with `& 0xFFFFFFFF` and splits every product into 16-bit halves:
// about 115 ops over every lane, some 3 KB a lane of device traffic.
//
// Here each thread draws one lane in native uint32_t arithmetic, where
// products and sums wrap mod 2^32 exactly as the plain version's masks
// do, and writes (word >> 8) * 2^-24 as one float4: the conversion of a
// 24-bit integer and the product by a power of two are exact, so the
// draw equals the plain version's bit for bit.
//
// A key word is a pointer with an element stride over the flattened
// lanes (0 where it broadcasts), to int32 or int64 words (masked to their
// low 32 bits, as `& M32` does), or an immediate 32-bit value passed as a
// launch argument, so a scalar word costs no copy from the host.
//
// What bounds it on an H100: bytes. A lane reads each pointer word once
// (4 or 8 B) and writes 16 B, against ~40 integer instructions. A
// grid-stride loop with one 16-byte store a lane is the whole design.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pcg4d.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;   // 8 resident blocks on each of 132 SMs

enum WordKind { kImmediate = 0, kInt32 = 1, kInt64 = 2 };

struct Word {
  const void* ptr;
  long long stride;
  int kind;
  uint32_t imm;
};

struct Key {
  Word w[4];
};

__device__ __forceinline__ uint32_t load_word(const Word& w, long long i) {
  if (w.kind == kInt32)
    return (uint32_t)__ldg((const int32_t*)w.ptr + i * w.stride);
  if (w.kind == kInt64)
    return (uint32_t)__ldg((const long long*)w.ptr + i * w.stride);
  return w.imm;
}

__global__ void __launch_bounds__(kThreads)
    pcg4d_uniform_kernel(Key key, long long n, float4* __restrict__ out) {
  const long long step = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += step) {
    const Pcg4 h = pcg4d(load_word(key.w[0], i), load_word(key.w[1], i),
                         load_word(key.w[2], i), load_word(key.w[3], i));
    out[i] = make_float4(to_unit(h.x), to_unit(h.y), to_unit(h.z),
                         to_unit(h.w));
  }
}

}  // namespace

extern "C" int pt_pcg4d_uniform(
    const void* p0, long long s0, int k0, unsigned imm0,
    const void* p1, long long s1, int k1, unsigned imm1,
    const void* p2, long long s2, int k2, unsigned imm2,
    const void* p3, long long s3, int k3, unsigned imm3,
    long long n, float* out, void* stream) {
  const Key key = {{{p0, s0, k0, imm0}, {p1, s1, k1, imm1},
                    {p2, s2, k2, imm2}, {p3, s3, k3, imm3}}};
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  pcg4d_uniform_kernel<<<(unsigned)blocks, kThreads, 0,
                         (cudaStream_t)stream>>>(key, n, (float4*)out);
  return (int)cudaGetLastError();
}
