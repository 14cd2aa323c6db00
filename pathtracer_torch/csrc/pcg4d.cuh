// The PCG4D hash of sampling/rng.py:pcg4d in native uint32_t arithmetic,
// shared by K9 (rng.cu) and K10 (shade.cu) so both compile the same
// integer code. Products and sums wrap mod 2^32 exactly as the plain
// version's `& 0xFFFFFFFF` masks do; to_unit keeps a word's top 24 bits
// scaled by 2^-24, which is exact, so a draw equals the plain version's
// bit for bit.

#pragma once

#include <stdint.h>

struct Pcg4 {
  uint32_t x, y, z, w;
};

__device__ __forceinline__ Pcg4 pcg4d(uint32_t x, uint32_t y, uint32_t z,
                                      uint32_t w) {
  x = x * 1664525u + 1013904223u;
  y = y * 1664525u + 1013904223u;
  z = z * 1664525u + 1013904223u;
  w = w * 1664525u + 1013904223u;
  x += y * w;
  y += z * x;
  z += x * y;
  w += y * z;
  x ^= x >> 16;
  y ^= y >> 16;
  z ^= z >> 16;
  w ^= w >> 16;
  x += y * w;
  y += z * x;
  z += x * y;
  w += y * z;
  return {x, y, z, w};
}

__device__ __forceinline__ float to_unit(uint32_t bits) {
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
}
