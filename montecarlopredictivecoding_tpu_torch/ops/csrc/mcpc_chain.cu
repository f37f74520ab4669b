// Fused whole-chain MCPC posterior inference for Hopper (sm_90a).
//
// Replaces: the JAX package's ops/pallas_mcpc.py::_make_packed_kernel
// (launched by mcpc_chain_pallas(packed=True) at its pl.pallas_call), the
// warm phase (warm_step: Adam MAP steps on the latents), the Langevin phase
// (step -> eval_grads, box_muller) and the final-step scalars (scal_sums).
// Activation relu; sensory loss bernoulli, gaussian or none.
//
// What it computes, per batch row (rows never read each other on this path):
//
//   err0 = x0 - b0;  err_l = x_l - (relu(x_{l-1}) W_l + b_l);
//   logits = relu(x2) W3 + b3;  S = sigmoid(logits) - y | (logits - y)/var | 0
//   G = [err0 | err1 | err2] - relu'(x) * [err1 W1^T | err2 W2^T | -S W3^T]
//   warm step:     Adam, optax operation order, bias powers carried in f32
//   Langevin step: x <- x - lr G + sqrt(lr var) z
//
// The noise z is the counter hash of the JAX package (_fmix32, _mock_bits,
// _uniforms, _sincos_2pi) evaluated per element at (seed + batch tile,
// draw, local_row * XW + 128-padded packed column), so this kernel can be
// held element by element against mcpc_chain_pallas(..., interpret=True).
// Step pair p reads draws 2p and 2p+1; step 2p takes r*cos, step 2p+1 r*sin.
//
// Bound on an H100: compute.  One step at width 20-128-128-784 is
// 4*B*(20*128 + 128*128 + 128*784) FLOP = 122 MFLOP at B=256, so a
// T=10000 chain is 1.22 TFLOP: 18 ms at the published 67 TFLOP/s f32 of an
// H100 SXM at 700 W.  Bytes (weights 477 KB, latents and target) are
// negligible next to that.
//
// Design (simple and right first):
//  * One block of NT threads runs the WHOLE chain (warm_T + T steps) for
//    ROWS batch rows, in one launch, with no communication between blocks.
//  * Shared memory holds the block's latents X, relu(X), errors, S, the
//    split-K partials of S W3^T and, for the warm phase, the Adam moments,
//    all feature-major ([feature][row]) so one float4 load feeds 4 rows.
//  * Weights stay in device memory and are read through L2 (477 KB in f32
//    does not fit in 227 KB of shared memory).  Each weight a thread loads
//    serves all ROWS rows from registers.  The wrapper stages W^T once, so
//    the backward products read coalesced too.
//  * The wrapper picks the largest ROWS in {16, 8, 4, 2, 1} whose shared
//    memory fits.  At B=256 that is 16 blocks: 16 of the 132 SMs.  Spreading
//    W3's columns over a thread-block cluster, or tensor cores at full f32
//    precision, is later work (ROADMAP.md, "Hopper design constraint").
//  * No --use_fast_math: tanhf, logf, log1pf, expf and sqrtf stay IEEE.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;           // threads per block
constexpr int NWARP = NT / 32;
constexpr int KS = 2;             // split of the K=D sum in S W3^T

struct ChainArgs {
  const float* x0; const float* x1; const float* x2;   // [B, d_l]
  float* o0; float* o1; float* o2;                     // [B, d_l]
  const float* y;                                      // [B, D]
  const float* b0; const float* b1; const float* b2; const float* b3;
  const float* w1; const float* w2; const float* w3;   // [in, out]
  const float* w1t; const float* w2t; const float* w3t;  // [out, in]
  double* scal;                                        // [n_blocks, 2]
  int B, d0, d1, d2, D;
  int T, warm_T, loss, want_scalars;                   // loss: 0 none, 1 bernoulli, 2 gaussian
  float inv_var, lr, noise_std;
  float warm_lr, wb1, wb2, one_m_b1, one_m_b2, weps;
  int seed, tile_B, XW, O1, O2;                        // noise indexing
};

// ---------------------------------------------------------------- noise

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

// Standard normal of Langevin step t at element index idx: Box-Muller over
// draws 2p, 2p+1 of pair p = t/2; even steps take the cos branch, odd the sin.
__device__ __forceinline__ float langevin_normal(uint32_t seed, int t, uint32_t idx) {
  const uint32_t draw = (uint32_t)(t >> 1) * 2u;
  const float u1 = 2.0f - unit_from_bits(counter_bits(seed, draw, idx));
  const float u2 = unit_from_bits(counter_bits(seed, draw + 1u, idx)) - 1.0f;
  const float r = sqrtf(-2.0f * logf(u1));
  float c, s;
  sincos_2pi(u2, c, s);
  return (t & 1) ? r * s : r * c;
}

// ------------------------------------------------------------ products

// acc[r] += a[r] * w for the R rows of one feature (a is [R], 16B aligned
// when R % 4 == 0)
template <int R>
__device__ __forceinline__ void row_fma(float (&acc)[R], const float* a, float w) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(a)[q];
      acc[4 * q + 0] = fmaf(v.x, w, acc[4 * q + 0]);
      acc[4 * q + 1] = fmaf(v.y, w, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(v.z, w, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(v.w, w, acc[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = fmaf(a[r], w, acc[r]);
  }
}

// acc[r] += sum_{k0 <= k < k1} A[k][r] * W[k * ldw + col]; A is shared
// [K][R], W a row-major matrix in device memory read through L2.
template <int R>
__device__ __forceinline__ void rows_dot(float (&acc)[R], const float* A,
                                         const float* __restrict__ W, int k0,
                                         int k1, int ldw, int col) {
  constexpr int U = 8;
  int k = k0;
  for (; k + U <= k1; k += U) {
    float w[U];
#pragma unroll
    for (int u = 0; u < U; ++u) w[u] = __ldg(W + (size_t)(k + u) * ldw + col);
#pragma unroll
    for (int u = 0; u < U; ++u) row_fma<R>(acc, A + (k + u) * R, w[u]);
  }
  for (; k < k1; ++k) row_fma<R>(acc, A + k * R, __ldg(W + (size_t)k * ldw + col));
}

// -------------------------------------------------------------- kernel

template <int R>
__global__ void __launch_bounds__(NT, 1) mcpc_chain_kernel(const ChainArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ double red[2][NWARP];
  __shared__ uint32_t row_seed[R];   // seed + batch tile of each row
  __shared__ uint32_t row_base[R];   // local_row * XW of each row

  const int n = a.d0 + a.d1 + a.d2;  // packed latent width (unpadded)
  const int c1 = a.d0;               // packed column where x1 starts
  const int c2 = a.d0 + a.d1;        // packed column where x2 starts
  float* X = smem;                   // [n][R] latents
  float* H = X + n * R;              // [n][R] relu(latents)
  float* E = H + n * R;              // [n][R] err0 | err1 | err2
  float* S = E + n * R;              // [D][R] dLoss/dlogits
  float* P = S + a.D * R;            // [KS][d2][R] partials of S W3^T
  float* M = P + KS * a.d2 * R;      // [n][R] Adam first moment (warm only)
  float* V = M + n * R;              // [n][R] Adam second moment (warm only)

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * R;

  if (tid < R) {
    const int row = row0 + tid;
    row_seed[tid] = (uint32_t)a.seed + (uint32_t)(row / a.tile_B);
    row_base[tid] = (uint32_t)(row % a.tile_B) * (uint32_t)a.XW;
  }
  for (int e = tid; e < R * n; e += NT) {
    const int r = e / n, c = e - r * n;
    const int row = row0 + r;
    float x = 0.f;
    if (row < a.B) {
      if (c < c1) x = a.x0[(size_t)row * a.d0 + c];
      else if (c < c2) x = a.x1[(size_t)row * a.d1 + (c - c1)];
      else x = a.x2[(size_t)row * a.d2 + (c - c2)];
    }
    X[c * R + r] = x;
    H[c * R + r] = fmaxf(x, 0.f);
    if (a.warm_T > 0) {
      M[c * R + r] = 0.f;
      V[c * R + r] = 0.f;
    }
  }
  __syncthreads();

  const bool has_s = a.loss != 0;
  const int total = a.warm_T + a.T;
  float b1p = a.wb1, b2p = a.wb2;     // Adam bias-correction powers
  double loss_acc = 0.0, en_acc = 0.0;

  // one latent column's update from its backward product back[r]
  auto update_column = [&](int c, const float (&back)[R], bool warm, int t,
                           float cw1, float cw2) {
    const uint32_t pc = c < c1 ? (uint32_t)c
                      : c < c2 ? (uint32_t)(a.O1 + c - c1)
                               : (uint32_t)(a.O2 + c - c2);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float x = X[c * R + r];
      const float g = E[c * R + r] - (x > 0.f ? 1.f : 0.f) * back[r];
      if (warm) {
        const float m = a.wb1 * M[c * R + r] + a.one_m_b1 * g;
        const float v = a.wb2 * V[c * R + r] + a.one_m_b2 * g * g;
        M[c * R + r] = m;
        V[c * R + r] = v;
        x = x - a.warm_lr * (m / cw1) / (sqrtf(v / cw2) + a.weps);
      } else {
        x = x - a.lr * g;
        if (a.noise_std > 0.f)
          x = x + a.noise_std * langevin_normal(row_seed[r], t, row_base[r] + pc);
      }
      X[c * R + r] = x;
      H[c * R + r] = fmaxf(x, 0.f);
    }
  };

  for (int s = 0; s < total; ++s) {
    const bool warm = s < a.warm_T;
    const int t = s - a.warm_T;
    const bool final_step = a.want_scalars && s == total - 1;
    const float cw1 = 1.0f - b1p, cw2 = 1.0f - b2p;

    // ---- forward: errors of every PC site and S at the sensory layer
    const int nf = n + (has_s ? a.D : 0);
    for (int j = tid; j < nf; j += NT) {
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.f;
      if (j < c1) {
        const float bj = __ldg(a.b0 + j);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float e = X[j * R + r] - bj;
          E[j * R + r] = e;
          if (final_step && row0 + r < a.B) en_acc += (double)e * e;
        }
      } else if (j < n) {
        const bool l1 = j < c2;
        const int col = l1 ? j - c1 : j - c2;
        if (l1) rows_dot<R>(acc, H, a.w1, 0, a.d0, a.d1, col);
        else rows_dot<R>(acc, H + c1 * R, a.w2, 0, a.d1, a.d2, col);
        const float bj = __ldg((l1 ? a.b1 : a.b2) + col);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float e = X[j * R + r] - (acc[r] + bj);
          E[j * R + r] = e;
          if (final_step && row0 + r < a.B) en_acc += (double)e * e;
        }
      } else {
        const int col = j - n;
        rows_dot<R>(acc, H + c2 * R, a.w3, 0, a.d2, a.D, col);
        const float bj = __ldg(a.b3 + col);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int row = row0 + r;
          const float lg = acc[r] + bj;
          const float yv = row < a.B ? __ldg(a.y + (size_t)row * a.D + col) : 0.f;
          S[col * R + r] = a.loss == 1 ? (0.5f + 0.5f * tanhf(0.5f * lg)) - yv
                                       : (lg - yv) * a.inv_var;
          if (final_step && row < a.B) {
            const double l = lg, yd = yv;
            loss_acc += a.loss == 1
                ? fmax(l, 0.0) - l * yd + log1p(exp(-fabs(l)))
                : 0.5 * (double)a.inv_var * (l - yd) * (l - yd);
          }
        }
      }
    }
    __syncthreads();

    // ---- backward: x0 and x1 columns update now; x2 columns get KS
    // partial sums of S W3^T
    const int nb = c2 + (has_s ? KS * a.d2 : 0);
    for (int j = tid; j < nb; j += NT) {
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.f;
      if (j < c2) {
        if (j < c1) rows_dot<R>(acc, E + c1 * R, a.w1t, 0, a.d1, a.d0, j);
        else rows_dot<R>(acc, E + c2 * R, a.w2t, 0, a.d2, a.d1, j - c1);
        update_column(j, acc, warm, t, cw1, cw2);
      } else {
        const int jj = j - c2;
        const int chunk = jj / a.d2, i = jj - chunk * a.d2;
        rows_dot<R>(acc, S, a.w3t, chunk * a.D / KS, (chunk + 1) * a.D / KS, a.d2, i);
#pragma unroll
        for (int r = 0; r < R; ++r) P[(chunk * a.d2 + i) * R + r] = acc[r];
      }
    }
    __syncthreads();

    // ---- x2 columns: back = -(S W3^T), summed over the chunks in order
    for (int i = tid; i < a.d2; i += NT) {
      float back[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float p = 0.f;
        if (has_s) {
          p = P[i * R + r];
          for (int k = 1; k < KS; ++k) p += P[(k * a.d2 + i) * R + r];
        }
        back[r] = -p;
      }
      update_column(c2 + i, back, warm, t, cw1, cw2);
    }
    __syncthreads();
    if (warm) {
      b1p *= a.wb1;
      b2p *= a.wb2;
    }
  }

  for (int e = tid; e < R * n; e += NT) {
    const int r = e / n, c = e - r * n;
    const int row = row0 + r;
    if (row >= a.B) continue;
    const float x = X[c * R + r];
    if (c < c1) a.o0[(size_t)row * a.d0 + c] = x;
    else if (c < c2) a.o1[(size_t)row * a.d1 + (c - c1)] = x;
    else a.o2[(size_t)row * a.d2 + (c - c2)] = x;
  }

  if (a.want_scalars) {
    for (int off = 16; off > 0; off >>= 1) {
      loss_acc += __shfl_down_sync(0xffffffffu, loss_acc, off);
      en_acc += __shfl_down_sync(0xffffffffu, en_acc, off);
    }
    if ((tid & 31) == 0) {
      red[0][tid >> 5] = loss_acc;
      red[1][tid >> 5] = en_acc;
    }
    __syncthreads();
    if (tid == 0) {
      double l = 0.0, en = 0.0;
      for (int w = 0; w < NWARP; ++w) {
        l += red[0][w];
        en += red[1][w];
      }
      a.scal[2 * blockIdx.x + 0] = l;
      a.scal[2 * blockIdx.x + 1] = 0.5 * en;
    }
  }
}

template <int R>
cudaError_t launch_rows(const ChainArgs& a, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mcpc_chain_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (a.B + R - 1) / R;
  mcpc_chain_kernel<R><<<blocks, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int R>
int static_smem_bytes() {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, mcpc_chain_kernel<R>) != cudaSuccess) return -1;
  return (int)attr.sharedSizeBytes;
}

int pad128(int d) { return (d + 127) / 128 * 128; }

}  // namespace

extern "C" {

// dynamic shared memory of one block of `rows` rows
size_t mcpc_chain_smem_bytes(int d0, int d1, int d2, int D, int rows, int warm) {
  const size_t n = (size_t)d0 + d1 + d2;
  const size_t floats = 3 * n + (size_t)D + (size_t)KS * d2 + (warm ? 2 * n : 0);
  return floats * (size_t)rows * sizeof(float);
}

// dynamic shared memory a block of `rows` rows may use on `device`, or -1
int mcpc_chain_smem_budget(int device, int rows) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  int fixed = -1;
  switch (rows) {
    case 16: fixed = static_smem_bytes<16>(); break;
    case 8: fixed = static_smem_bytes<8>(); break;
    case 4: fixed = static_smem_bytes<4>(); break;
    case 2: fixed = static_smem_bytes<2>(); break;
    case 1: fixed = static_smem_bytes<1>(); break;
    default: return -1;
  }
  return fixed < 0 ? -1 : optin - fixed;
}

const char* mcpc_chain_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Runs warm_T Adam steps then T Langevin steps for every batch row.  All
// pointers are device pointers; scal receives [n_blocks, 2] (loss, energy)
// partial sums when want_scalars.  Returns a cudaError_t (0 on success).
int mcpc_chain_launch(
    const float* x0, const float* x1, const float* x2,
    float* o0, float* o1, float* o2,
    const float* y,
    const float* b0, const float* b1, const float* b2, const float* b3,
    const float* w1, const float* w2, const float* w3,
    const float* w1t, const float* w2t, const float* w3t,
    double* scal,
    int B, int d0, int d1, int d2, int D,
    int T, int warm_T, int loss, int want_scalars, int rows,
    float inv_var, float lr, float noise_std,
    float warm_lr, float wb1, float wb2, float one_m_b1, float one_m_b2,
    float weps, int seed, int tile_B, void* stream) {
  if (B <= 0 || d0 <= 0 || d1 <= 0 || d2 <= 0 || D <= 0 || T < 0 ||
      warm_T < 0 || tile_B <= 0 || loss < 0 || loss > 2)
    return (int)cudaErrorInvalidValue;
  ChainArgs a;
  a.x0 = x0; a.x1 = x1; a.x2 = x2;
  a.o0 = o0; a.o1 = o1; a.o2 = o2;
  a.y = y;
  a.b0 = b0; a.b1 = b1; a.b2 = b2; a.b3 = b3;
  a.w1 = w1; a.w2 = w2; a.w3 = w3;
  a.w1t = w1t; a.w2t = w2t; a.w3t = w3t;
  a.scal = scal;
  a.B = B; a.d0 = d0; a.d1 = d1; a.d2 = d2; a.D = D;
  a.T = T; a.warm_T = warm_T; a.loss = loss; a.want_scalars = want_scalars;
  a.inv_var = inv_var; a.lr = lr; a.noise_std = noise_std;
  a.warm_lr = warm_lr; a.wb1 = wb1; a.wb2 = wb2;
  a.one_m_b1 = one_m_b1; a.one_m_b2 = one_m_b2; a.weps = weps;
  a.seed = seed; a.tile_B = tile_B;
  a.O1 = pad128(d0);
  a.O2 = a.O1 + pad128(d1);
  a.XW = a.O2 + pad128(d2);
  const size_t smem = mcpc_chain_smem_bytes(d0, d1, d2, D, rows, warm_T > 0);
  cudaStream_t st = (cudaStream_t)stream;
  switch (rows) {
    case 16: return (int)launch_rows<16>(a, smem, st);
    case 8: return (int)launch_rows<8>(a, smem, st);
    case 4: return (int)launch_rows<4>(a, smem, st);
    case 2: return (int)launch_rows<2>(a, smem, st);
    case 1: return (int)launch_rows<1>(a, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
