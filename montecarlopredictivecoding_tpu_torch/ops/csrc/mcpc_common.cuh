// Device code shared by the MCPC chain kernels (mcpc_cluster.cuh, which
// mcpc_chain.cu and mcpc_chain_unpacked.cu instantiate): the threads of a
// block, the counter-hash noise and the layout of a partial of the
// parameter gradients.
//
// bf16 products.  Each source is compiled twice (ops/_build.py): as it is,
// and with -DMCPC_BF16, which sets kBF16 and so instantiates its kernels for
// bf16 products: every matrix product takes operands rounded to bf16 (to
// nearest, ties to even: the JAX package's astype(jnp.bfloat16)) and runs on
// the tensor cores with f32 sums (mcpc_cluster.cuh, "bf16 products").  The
// f32 build carries none of that code.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace mcpc {

constexpr int NT = 256;           // threads per block
constexpr int NWARP = NT / 32;

#ifdef MCPC_BF16
constexpr bool kBF16 = true;      // this build's kernels take bf16 operands
#else
constexpr bool kBF16 = false;
#endif

// ---------------------------------------------------------------- noise
//
// The stateless counter hash of the JAX package (_fmix32, _mock_bits,
// _uniforms, _sincos_2pi): a draw is a pure function of (seed, draw number,
// element index).

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t counter_bits(uint32_t seed, uint32_t draw,
                                                 uint32_t idx) {
  const uint32_t h = seed * 0x9E3779B1u + draw * 0x6C62272Eu;
  return fmix32(fmix32(h + idx) ^ 0xA511E9B3u);
}

// (bits >> 9) | 0x3F800000 read as a float lies in [1, 2)
__device__ __forceinline__ float unit_from_bits(uint32_t b) {
  return __uint_as_float((b >> 9) | 0x3F800000u);
}

// (cos 2 pi u, sin 2 pi u) for u in [0, 1): quadrant reduction and the same
// Taylor polynomials as the JAX package's _sincos_2pi (constants rounded
// from double to float as JAX rounds them).
__device__ __forceinline__ void sincos_2pi(float u, float& c_out, float& s_out) {
  const float t = 4.0f * u;
  const float q = floorf(t);
  const float x = (float)1.5707963267948966 * (t - q);
  const float x2 = x * x;
  const float s = x * (1.0f + x2 * ((float)-1.66666667e-1 + x2 * ((float)8.33333333e-3
      + x2 * ((float)-1.98412698e-4 + x2 * ((float)2.75573192e-6
      + x2 * ((float)-2.50521084e-8))))));
  const float c = 1.0f + x2 * (-0.5f + x2 * ((float)4.16666667e-2
      + x2 * ((float)-1.38888889e-3 + x2 * ((float)2.48015873e-5
      + x2 * ((float)-2.75573192e-7 + x2 * (float)2.08767570e-9)))));
  const int qi = ((int)q) & 3;
  const bool swap = (qi & 1) == 1;
  const float s1 = swap ? c : s;
  const float c1 = swap ? s : c;
  c_out = (qi == 1 || qi == 2) ? -c1 : c1;
  s_out = (qi >= 2) ? -s1 : s1;
}

// One Box-Muller normal from draws `draw` and `draw + 1` at element `idx`:
// r*sin when take_sin, else r*cos.
__device__ __forceinline__ float box_muller(uint32_t seed, uint32_t draw,
                                            uint32_t idx, bool take_sin) {
  const float u1 = 2.0f - unit_from_bits(counter_bits(seed, draw, idx));
  const float u2 = unit_from_bits(counter_bits(seed, draw + 1u, idx)) - 1.0f;
  const float r = sqrtf(-2.0f * logf(u1));
  float c, s;
  sincos_2pi(u2, c, s);
  return take_sin ? r * s : r * c;
}

// ------------------------------------------------- parameter gradients
//
// A cluster's share of the Hebbian gradients lives in device memory, one
// "partial" per cluster, laid out [gW1 | gW2 | gW3 | gb0 | gb1 | gb2 | gb3].
// Each block of the cluster owns a fixed slice of it and each of its
// threads always the same elements, so a read-modify-write needs no atomics
// and no fence, and the order of every sum is fixed.  A second pass sums the
// partials over the clusters.

struct PartialLayout {
  float* gw1; float* gw2; float* gw3;
  float* gb0; float* gb1; float* gb2; float* gb3;
};

__host__ __device__ inline size_t partial_floats(int d0, int d1, int d2, int D) {
  return (size_t)d0 * d1 + (size_t)d1 * d2 + (size_t)d2 * D + d0 + d1 + d2 + D;
}

__device__ __forceinline__ PartialLayout partial_layout(float* p, int d0, int d1,
                                                        int d2, int D) {
  PartialLayout l;
  l.gw1 = p;
  l.gw2 = l.gw1 + (size_t)d0 * d1;
  l.gw3 = l.gw2 + (size_t)d1 * d2;
  l.gb0 = l.gw3 + (size_t)d2 * D;
  l.gb1 = l.gb0 + d0;
  l.gb2 = l.gb1 + d1;
  l.gb3 = l.gb2 + d2;
  return l;
}

}  // namespace mcpc
