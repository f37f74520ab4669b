// The per-op cost probe for Hopper (sm_90a): one elementwise step, repeated
// T times on every element of a [B, 384] f32 tile.
//
// Replaces: the JAX package's benchmarks/vpu_op_bench.py::run_variant kernel
// (lines 101-119, its pl.pallas_call at :110) with make_variant's 14 steps
// (lines 53-95).  The Python side, its plain PyTorch versions and the
// marginal fit live in benchmarks/vpu_op_bench.py of this package.
//
// It times the chain kernel's own device functions, not copies of them:
// counter_bits, unit_from_bits and sincos_2pi come from mcpc_common.cuh.  The
// draws are the port's counter hash (the TPU's on-core PRNG has no CUDA
// counterpart): prng reads draw t, the Box-Muller variants draws 2t and 2t+1,
// at element index row * 384 + col.  The library functions (logf, sqrtf,
// rsqrtf, sinf, cosf, expf, tanhf, division) are the accurate ones: the
// build has no --use_fast_math, as the chain kernel's has not.
//
// The step's own arithmetic is written with __fmul_rn and __fadd_rn, which
// nvcc does not contract into FMAs, so each step rounds where the plain
// version (and the JAX body) rounds.  Kernel and plain version then differ
// only by the math library's ulps, also where x grows: prng at noise scale
// 1 reaches about 96 after 64 steps, where one f32 ulp is 7.6e-6.
//
// Design.  The TPU kernel held the tile in one core's VMEM and ran a serial
// fori_loop over it.  Here the elements are independent, so nothing crosses
// threads or blocks and no shared memory is used: one thread an element
// keeps x in a register, runs the T-step loop on it and writes x once at the
// end.  The loop is unrolled UNROLL times, so its counter, compare and branch
// cost an eighth of a step's issue slots; the loop-carried x keeps the
// compiler from folding steps together.  Blocks of NT = 256 threads; at
// B = 256 the 98,304 elements make 384 blocks, all resident in one wave:
// 120 SMs run 3 blocks and 12 run 2, so the busiest SMs carry 768 elements
// against the even share of 744.7 (a 3% tail).  Three blocks of 256 fit
// while a thread takes at most 85 registers (chip_smoke.py prints ptxas's
// count in phase 0).  Each SM sub-partition then holds 6 warps, one
// dependent chain each.
//
// Bound.  No bytes to speak of (x read once, written once).  It is bound by
// operations: those each step needs per element, by pipe, over the H100's
// rates per SM per clock (CUDA C++ Programming Guide, compute capability
// 9.0): 128 FP32 add/multiply/FMA, 16 MUFU (RCP, RSQ, SQRT, LG2, EX2, SIN,
// COS, TANH: a library function counts as its one MUFU operation), 64
// 32-bit integer multiplies (the hash's IMADs), 64 logic operations (its
// xors; compares, selects), 16 conversions, and one warp instruction issued
// a clock per sub-partition (128 operations an SM), which also bounds the
// hash's shifts (they run on the ALU or the multiply pipe).  The slowest
// pipe sets the bound; benchmarks/vpu_op_bench.py holds the counts of the
// fewest instructions a step needs (STEP_OPS), and the loop's own work is
// not in them.  The library's accurate logf, sinf, expf and the rest take
// many more instructions than their MUFU operation, so those variants sit
// well above their bound; with 6 warps a sub-partition, a step whose
// dependent chain is longer than 6 times its instruction count in clocks
// sits at that latency instead.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mcpc_common.cuh"

namespace {

using namespace mcpc;

// the order of VARIANTS in benchmarks/vpu_op_bench.py
enum Variant : int {
  BASELINE, PRNG, LOG, SQRT, RSQRT, SQRT_VIA_RSQRT, SIN, COS, EXP, SIGMOID,
  TANH, SIGMOID_TANH, BM_HW, BM_POLY, N_VARIANT
};

// steps a trip of the T-step loop
constexpr int UNROLL = 8;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// x * 0.1 + v: the frame of the deterministic variants
__device__ __forceinline__ float damped(float x, float v) { return add(mul(x, 0.1f), v); }

// x * 0.9999 + v: the frame of the baseline and the random variants
__device__ __forceinline__ float leaky(float x, float v) { return add(mul(x, 0.9999f), v); }

// step t of variant V at element idx; `scale` is the noise scale
template <int V>
__device__ __forceinline__ float step(float x, uint32_t seed, uint32_t t, uint32_t idx,
                                      float scale) {
  if constexpr (V == BASELINE) {
    return leaky(x, 1e-4f);
  } else if constexpr (V == PRNG) {
    return leaky(x, mul(scale, unit_from_bits(counter_bits(seed, t, idx))));
  } else if constexpr (V == LOG) {
    return damped(x, logf(add(fabsf(x), 1.0f)));
  } else if constexpr (V == SQRT) {
    return damped(x, sqrtf(add(fabsf(x), 1.0f)));
  } else if constexpr (V == RSQRT) {
    return damped(x, rsqrtf(add(fabsf(x), 1.0f)));
  } else if constexpr (V == SQRT_VIA_RSQRT) {
    const float v = add(fabsf(x), 1.0f);
    return damped(x, mul(v, rsqrtf(v)));
  } else if constexpr (V == SIN) {
    return damped(x, sinf(x));
  } else if constexpr (V == COS) {
    return damped(x, cosf(x));
  } else if constexpr (V == EXP) {
    return damped(x, expf(-fabsf(x)));
  } else if constexpr (V == SIGMOID) {
    return damped(x, 1.0f / add(1.0f, expf(-x)));
  } else if constexpr (V == TANH) {
    return damped(x, tanhf(x));
  } else if constexpr (V == SIGMOID_TANH) {
    return damped(x, add(0.5f, mul(0.5f, tanhf(mul(0.5f, x)))));
  } else {
    static_assert(V == BM_HW || V == BM_POLY, "unknown variant");
    // u1 = 2 - f1 in (0, 1], u2 = f2 - 1 in [0, 1): both exact
    const float u1 = 2.0f - unit_from_bits(counter_bits(seed, 2u * t, idx));
    const float u2 = unit_from_bits(counter_bits(seed, 2u * t + 1u, idx)) - 1.0f;
    const float r = sqrtf(mul(-2.0f, logf(u1)));
    float c, s;
    if constexpr (V == BM_HW) {
      const float th = mul((float)(2.0 * 3.14159265358979323846), u2);
      c = cosf(th);
      s = sinf(th);
    } else {
      sincos_2pi(u2, c, s);
    }
    return leaky(x, mul(scale, add(mul(r, c), mul(r, s))));
  }
}

template <int V>
__global__ void __launch_bounds__(NT) probe_kernel(const float* __restrict__ x_in,
                                                   float* __restrict__ out, int n, int T,
                                                   uint32_t seed, float scale) {
  const int idx = blockIdx.x * NT + threadIdx.x;
  if (idx >= n) return;
  float x = x_in[idx];
#pragma unroll UNROLL
  for (int t = 0; t < T; ++t) x = step<V>(x, seed, (uint32_t)t, (uint32_t)idx, scale);
  out[idx] = x;
}

__global__ void __launch_bounds__(NT) sincos_kernel(const float* __restrict__ u,
                                                    float* __restrict__ c,
                                                    float* __restrict__ s, int n) {
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i < n) sincos_2pi(u[i], c[i], s[i]);
}

template <int V>
cudaError_t launch(const float* x, float* out, int n, int T, uint32_t seed, float scale,
                   cudaStream_t stream) {
  probe_kernel<V><<<(n + NT - 1) / NT, NT, 0, stream>>>(x, out, n, T, seed, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int op_probe_variant_count() { return N_VARIANT; }

// out[i] = x[i] after T steps of variant `variant` (Variant's order), for
// the n elements of a [B, 384] tile; the draws are keyed `seed`
int op_probe_launch(int variant, const float* x, float* out, int n, int T, unsigned seed,
                    float scale, void* stream) {
  if (n <= 0 || T < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (variant) {
#define OP_PROBE_CASE(V) case V: return (int)launch<V>(x, out, n, T, seed, scale, st);
    OP_PROBE_CASE(BASELINE) OP_PROBE_CASE(PRNG) OP_PROBE_CASE(LOG) OP_PROBE_CASE(SQRT)
    OP_PROBE_CASE(RSQRT) OP_PROBE_CASE(SQRT_VIA_RSQRT) OP_PROBE_CASE(SIN) OP_PROBE_CASE(COS)
    OP_PROBE_CASE(EXP) OP_PROBE_CASE(SIGMOID) OP_PROBE_CASE(TANH)
    OP_PROBE_CASE(SIGMOID_TANH) OP_PROBE_CASE(BM_HW) OP_PROBE_CASE(BM_POLY)
#undef OP_PROBE_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

// (c[i], s[i]) = the chain kernel's sincos_2pi(u[i]), for i < n
int op_probe_sincos_2pi(const float* u, float* c, float* s, int n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  sincos_kernel<<<(n + NT - 1) / NT, NT, 0, (cudaStream_t)stream>>>(u, c, s, n);
  return (int)cudaGetLastError();
}

const char* op_probe_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
