// The unpacked MCPC Langevin chain for Hopper (sm_90a): the readable baseline
// that the packed kernel (mcpc_chain.cu) is held against.
//
// Replaces: the JAX package's ops/pallas_mcpc.py::_make_kernel (launched by
// mcpc_chain_pallas(packed=False) at its second pl.pallas_call).  relu only,
// no warm phase, no scalars, one batch tile; sensory loss bernoulli, gaussian
// or none; parameter gradients over the steps t >= mixing.
//
// One Langevin step, written as the TPU kernel is meant to be read: one
// product per layer per direction, each latent with its own arrays.
//
//   err0 = x0 - b0            h_l = relu(x_l)
//   err1 = x1 - (h0 W1 + b1)  err2 = x2 - (h1 W2 + b2)
//   logits = h2 W3 + b3       s = sigmoid(logits) - y | (logits - y)/var | 0
//   g2 = err2 + relu'(x2) * (s W3^T)
//   g1 = err1 - relu'(x1) * (err2 W2^T)
//   g0 = err0 - relu'(x0) * (err1 W1^T)
//   if t >= mixing:  gW3 += h2^T s      gb3 += sum s
//                    gW2 += h1^T -err2  gb2 += sum -err2
//                    gW1 += h0^T -err1  gb1 += sum -err1   gb0 += sum -err0
//   x_l <- x_l - lr g_l + sqrt(lr var) n_l
//
// Noise.  Not the packed kernel's: n_l is _normals(x_l.shape) of the JAX
// package with the seed unshifted.  Step t reads draws 6t+{0,1} for x0,
// 6t+{2,3} for x1, 6t+{4,5} for x2, over a [B, half] grid with
// half = (d_l + 1) / 2 and element index row * half + col: column c < half
// takes r*cos at col = c, column c >= half takes r*sin at col = c - half.
// The hash itself is shared with the packed kernel (mcpc_common.cuh).
//
// bf16 products (the JAX kernel's bf16_matmul: its mm rounds both operands
// of every product).  The build with -DMCPC_BF16 (mcpc_common.cuh) stores
// h_l rounded to bf16 (relu' reads x_l), rounds err1, err2 and s as the
// backward products and the gradient products read them, and takes W and
// W^T rounded once by the wrapper; err_l and s themselves, the bias
// gradients and the update stay f32.
//
// Bound on an H100: operations, as the packed kernel (4*B*(d0 d1 + d1 d2 +
// d2 D) FLOP a step, plus half of that on a step that samples).
//
// Design: the packed kernel's, minus what this baseline does not have.  One
// block of NT threads runs the whole chain for R batch rows; shared memory
// holds x_l, h_l, err_l and s feature-major; weights are read through L2;
// the wrapper stages W^T once.  The K = D sum of s W3^T is NOT split here:
// 128 threads walk 784 weights each while the others wait, which is what
// "one product per layer per direction" costs on this card.  Parameter
// gradients go to a partial per block in device memory and are summed over
// blocks by the packed library's second pass (mcpc_common.cuh, mcpc_chain.cu),
// with no atomics, so repeats give the same bits.  No --use_fast_math.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mcpc_common.cuh"

namespace {

using namespace mcpc;

struct UnpackedArgs {
  const float* x0; const float* x1; const float* x2;   // [B, d_l]
  float* o0; float* o1; float* o2;                     // [B, d_l]
  const float* y;                                      // [B, D]
  const float* b0; const float* b1; const float* b2; const float* b3;
  const float* w1; const float* w2; const float* w3;   // [in, out]
  const float* w1t; const float* w2t; const float* w3t;  // [out, in]
  float* partials;                                     // [n_blocks, partial_floats] or null
  int B, d0, d1, d2, D;
  int T, loss, mixing;                                // loss: 0 none, 1 bernoulli, 2 gaussian
  float inv_var, lr, noise_std;
  int seed;
};

// _normals of the JAX package at (row, column c) of a [B, d] latent: draws
// `draw` and `draw + 1` at the element row * half + (c mod half)
__device__ __forceinline__ float latent_normal(uint32_t seed, uint32_t draw,
                                               int row, int c, int d) {
  const int half = (d + 1) / 2;
  const bool take_sin = c >= half;
  const uint32_t idx = (uint32_t)row * (uint32_t)half + (uint32_t)(take_sin ? c - half : c);
  return box_muller(seed, draw, idx, take_sin);
}

// BF16: the products take bf16 operands (header)
template <int R, bool BF16>
__global__ void __launch_bounds__(NT, 1) mcpc_chain_unpacked_kernel(const UnpackedArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int d0 = a.d0, d1 = a.d1, d2 = a.d2, D = a.D;
  float* X0 = smem;            float* X1 = X0 + d0 * R;  float* X2 = X1 + d1 * R;
  float* H0 = X2 + d2 * R;     float* H1 = H0 + d0 * R;  float* H2 = H1 + d1 * R;
  float* E0 = H2 + d2 * R;     float* E1 = E0 + d0 * R;  float* E2 = E1 + d1 * R;
  float* S = E2 + d2 * R;      // [D][R]

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * R;
  const int nvalid = min(R, a.B - row0);   // rows of this block inside the batch

  auto load = [&](float* X, float* H, const float* src, int d) {
    for (int e = tid; e < R * d; e += NT) {
      const int r = e / d, c = e - r * d;
      const float x = row0 + r < a.B ? src[(size_t)(row0 + r) * d + c] : 0.f;
      X[c * R + r] = x;
      H[c * R + r] = operand<BF16>(fmaxf(x, 0.f));
    }
  };
  load(X0, H0, a.x0, d0);
  load(X1, H1, a.x1, d1);
  load(X2, H2, a.x2, d2);
  PartialLayout pg = {};
  if (a.partials != nullptr) {
    const size_t np = partial_floats(d0, d1, d2, D);
    float* mine = a.partials + (size_t)blockIdx.x * np;
    for (size_t e = tid; e < np; e += NT) mine[e] = 0.f;
    pg = partial_layout(mine, d0, d1, d2, D);
  }
  __syncthreads();

  const bool has_s = a.loss != 0;

  // Langevin update of column c of one latent from its gradient g[r]
  auto update = [&](float* X, float* H, int c, const float (&g)[R], int d,
                    uint32_t draw) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float x = X[c * R + r] - a.lr * g[r];
      if (a.noise_std > 0.f)
        x = x + a.noise_std * latent_normal((uint32_t)a.seed, draw, row0 + r, c, d);
      X[c * R + r] = x;
      H[c * R + r] = operand<BF16>(fmaxf(x, 0.f));
    }
  };

  for (int t = 0; t < a.T; ++t) {
    // ---- forward: predictions and errors, one product per layer
    const int nf = d0 + d1 + d2 + (has_s ? D : 0);
    for (int j = tid; j < nf; j += NT) {
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.f;
      if (j < d0) {
        const float bj = __ldg(a.b0 + j);
#pragma unroll
        for (int r = 0; r < R; ++r) E0[j * R + r] = X0[j * R + r] - bj;
      } else if (j < d0 + d1) {
        const int col = j - d0;
        rows_dot<R>(acc, H0, a.w1, 0, d0, d1, col);
        const float bj = __ldg(a.b1 + col);
#pragma unroll
        for (int r = 0; r < R; ++r) E1[col * R + r] = X1[col * R + r] - (acc[r] + bj);
      } else if (j < d0 + d1 + d2) {
        const int col = j - d0 - d1;
        rows_dot<R>(acc, H1, a.w2, 0, d1, d2, col);
        const float bj = __ldg(a.b2 + col);
#pragma unroll
        for (int r = 0; r < R; ++r) E2[col * R + r] = X2[col * R + r] - (acc[r] + bj);
      } else {
        const int col = j - d0 - d1 - d2;
        rows_dot<R>(acc, H2, a.w3, 0, d2, D, col);
        const float bj = __ldg(a.b3 + col);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int row = row0 + r;
          const float lg = acc[r] + bj;
          const float yv = row < a.B ? __ldg(a.y + (size_t)row * D + col) : 0.f;
          S[col * R + r] = a.loss == 1 ? (0.5f + 0.5f * tanhf(0.5f * lg)) - yv
                                       : (lg - yv) * a.inv_var;
        }
      }
    }
    __syncthreads();

    // ---- parameter gradients over the sampling window, from the state
    // before the update; the barrier keeps the backward pass off h_l
    if (a.partials != nullptr && t >= a.mixing) {
      if (has_s) hebbian_accumulate<R, BF16>(pg.gw3, pg.gb3, H2, S, d2, D, 1.f, nvalid, tid);
      hebbian_accumulate<R, BF16>(pg.gw2, pg.gb2, H1, E2, d1, d2, -1.f, nvalid, tid);
      hebbian_accumulate<R, BF16>(pg.gw1, pg.gb1, H0, E1, d0, d1, -1.f, nvalid, tid);
      prior_bias_accumulate<R>(pg.gb0, E0, d0, nvalid, tid);
      __syncthreads();
    }

    // ---- backward through one layer each, then the Langevin update.  The
    // products read only err1, err2 and s, which this pass does not write.
    const uint32_t draw = (uint32_t)t * 6u;
    for (int j = tid; j < d0 + d1 + d2; j += NT) {
      float back[R], g[R];
#pragma unroll
      for (int r = 0; r < R; ++r) back[r] = 0.f;
      if (j < d0) {
        rows_dot<R, BF16>(back, E1, a.w1t, 0, d1, d0, j);
#pragma unroll
        for (int r = 0; r < R; ++r)
          g[r] = E0[j * R + r] - (X0[j * R + r] > 0.f ? 1.f : 0.f) * back[r];
        update(X0, H0, j, g, d0, draw);
      } else if (j < d0 + d1) {
        const int c = j - d0;
        rows_dot<R, BF16>(back, E2, a.w2t, 0, d2, d1, c);
#pragma unroll
        for (int r = 0; r < R; ++r)
          g[r] = E1[c * R + r] - (X1[c * R + r] > 0.f ? 1.f : 0.f) * back[r];
        update(X1, H1, c, g, d1, draw + 2u);
      } else {
        const int c = j - d0 - d1;
        if (has_s) rows_dot<R, BF16>(back, S, a.w3t, 0, D, d2, c);
#pragma unroll
        for (int r = 0; r < R; ++r)
          g[r] = E2[c * R + r] + (X2[c * R + r] > 0.f ? 1.f : 0.f) * back[r];
        update(X2, H2, c, g, d2, draw + 4u);
      }
    }
    __syncthreads();
  }

  auto store = [&](float* dst, const float* X, int d) {
    for (int e = tid; e < R * d; e += NT) {
      const int r = e / d, c = e - r * d;
      if (row0 + r < a.B) dst[(size_t)(row0 + r) * d + c] = X[c * R + r];
    }
  };
  store(a.o0, X0, d0);
  store(a.o1, X1, d1);
  store(a.o2, X2, d2);
}

// this build's kernel: f32 products, or bf16 ones with -DMCPC_BF16
template <int R>
cudaError_t launch_rows(const UnpackedArgs& a, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mcpc_chain_unpacked_kernel<R, kBF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (a.B + R - 1) / R;
  mcpc_chain_unpacked_kernel<R, kBF16><<<blocks, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int R>
int static_smem_bytes() {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, mcpc_chain_unpacked_kernel<R, kBF16>) != cudaSuccess)
    return -1;
  return (int)attr.sharedSizeBytes;
}

}  // namespace

extern "C" {

// dynamic shared memory of one block of `rows` rows
size_t mcpc_chain_unpacked_smem_bytes(int d0, int d1, int d2, int D, int rows) {
  const size_t n = (size_t)d0 + d1 + d2;
  return (3 * n + (size_t)D) * (size_t)rows * sizeof(float);
}

// dynamic shared memory a block of `rows` rows may use on `device`, or -1
int mcpc_chain_unpacked_smem_budget(int device, int rows) {
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

const char* mcpc_chain_unpacked_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Runs T Langevin steps for every batch row.  All pointers are device
// pointers.  With partials not null (room for [ceil(B / rows),
// partial_floats] floats) every block leaves there its share of the
// parameter gradients, taken on steps t >= mixing.  In the bf16 build the
// weights (w1..w3 and their transposes) must be rounded to bf16 already.
// Returns a cudaError_t (0 on success).
int mcpc_chain_unpacked_launch(
    const float* x0, const float* x1, const float* x2,
    float* o0, float* o1, float* o2,
    const float* y,
    const float* b0, const float* b1, const float* b2, const float* b3,
    const float* w1, const float* w2, const float* w3,
    const float* w1t, const float* w2t, const float* w3t,
    float* partials,
    int B, int d0, int d1, int d2, int D,
    int T, int loss, int mixing, int rows,
    float inv_var, float lr, float noise_std, int seed, void* stream) {
  if (B <= 0 || d0 <= 0 || d1 <= 0 || d2 <= 0 || D <= 0 || T < 0 ||
      loss < 0 || loss > 2)
    return (int)cudaErrorInvalidValue;
  UnpackedArgs a;
  a.x0 = x0; a.x1 = x1; a.x2 = x2;
  a.o0 = o0; a.o1 = o1; a.o2 = o2;
  a.y = y;
  a.b0 = b0; a.b1 = b1; a.b2 = b2; a.b3 = b3;
  a.w1 = w1; a.w2 = w2; a.w3 = w3;
  a.w1t = w1t; a.w2t = w2t; a.w3t = w3t;
  a.partials = partials;
  a.B = B; a.d0 = d0; a.d1 = d1; a.d2 = d2; a.D = D;
  a.T = T; a.loss = loss; a.mixing = mixing;
  a.inv_var = inv_var; a.lr = lr; a.noise_std = noise_std;
  a.seed = seed;
  const size_t smem = mcpc_chain_unpacked_smem_bytes(d0, d1, d2, D, rows);
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
