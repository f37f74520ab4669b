// Fused whole-chain MCPC posterior inference for Hopper (sm_90a).
//
// Replaces: the JAX package's ops/pallas_mcpc.py::_make_packed_kernel
// (launched by mcpc_chain_pallas(packed=True) at its pl.pallas_call), the
// warm phase (warm_step: Adam MAP steps on the latents), the Langevin phase
// (step -> eval_grads, box_muller), the final-step scalars (scal_sums) and
// the Hebbian parameter gradients (accum_pgrads, with_pgrads / warm_pgrads,
// summed across batch tiles).  Activation relu; sensory loss bernoulli,
// gaussian or none.
//
// What it computes, per batch row (rows never read each other on this path):
//
//   err0 = x0 - b0;  err_l = x_l - (relu(x_{l-1}) W_l + b_l);
//   logits = relu(x2) W3 + b3;  S = sigmoid(logits) - y | (logits - y)/var | 0
//   G = [err0 | err1 | err2] - relu'(x) * [err1 W1^T | err2 W2^T | -S W3^T]
//   warm step:     Adam, optax operation order, bias powers carried in f32
//   Langevin step: x <- x - lr G + sqrt(lr var) z
//   sampling step (Langevin t >= mixing, or the last warm step), from the
//   state BEFORE the update, summed over the batch:
//     gW1 += -relu(x0)^T err1   gW2 += -relu(x1)^T err2   gW3 += relu(x2)^T S
//     gb0 += -err0   gb1 += -err1   gb2 += -err2   gb3 += S
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
//
// Parameter gradients.  The TPU kernel keeps one gW accumulator resident in
// fast memory and walks the batch tiles in order.  Here the blocks run in
// parallel and never talk, and gW1+gW2+gW3 (119,296 floats, 477 KB at width
// 20-128-128-784) fit neither a block's registers nor its shared memory.
// So every block keeps a partial accumulator of its own in device memory
// (16 blocks x 481 KB at B=256, resident in L2).  On a sampling step, after
// the forward pass has left relu(X), the errors and S of the pre-update
// state in shared memory and before the backward pass overwrites relu(X),
// each thread read-modify-writes the elements of the partial it owns
// (mcpc_common.cuh, hebbian_accumulate).  A second kernel,
// sum_partials_kernel, then adds the partials over blocks in block order.
// No atomics anywhere: the order of every sum is fixed, so two runs on the
// same inputs give the same bits.  Rows that only pad the last block evolve
// like real rows (their latents start at 0), so every sum skips them.
// Steps that do not sample run the code they ran without gradients, plus
// one uniform branch.  A sampling step adds one product of the size of the
// forward pass (61 MFLOP at B=256) and one read and one write of the
// block's partial through L2.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mcpc_common.cuh"

namespace {

using namespace mcpc;

constexpr int KS = 2;             // split of the K=D sum in S W3^T

struct ChainArgs {
  const float* x0; const float* x1; const float* x2;   // [B, d_l]
  float* o0; float* o1; float* o2;                     // [B, d_l]
  const float* y;                                      // [B, D]
  const float* b0; const float* b1; const float* b2; const float* b3;
  const float* w1; const float* w2; const float* w3;   // [in, out]
  const float* w1t; const float* w2t; const float* w3t;  // [out, in]
  double* scal;                                        // [n_blocks, 2]
  float* partials;                                     // [n_blocks, partial_floats] or null
  int B, d0, d1, d2, D;
  int T, warm_T, loss, want_scalars;                   // loss: 0 none, 1 bernoulli, 2 gaussian
  int mixing, pg_warm;         // with partials: sample Langevin steps t >= mixing,
                               // and with pg_warm the last warm step
  float inv_var, lr, noise_std;
  float warm_lr, wb1, wb2, one_m_b1, one_m_b2, weps;
  int seed, tile_B, XW, O1, O2;                        // noise indexing
};

// Standard normal of Langevin step t at element index idx: Box-Muller over
// draws 2p, 2p+1 of pair p = t/2; even steps take the cos branch, odd the sin.
__device__ __forceinline__ float langevin_normal(uint32_t seed, int t, uint32_t idx) {
  return box_muller(seed, (uint32_t)(t >> 1) * 2u, idx, (t & 1) != 0);
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
  const int nvalid = min(R, a.B - row0);   // rows of this block inside the batch
  PartialLayout pg = {};
  if (a.partials != nullptr) {
    const size_t np = partial_floats(a.d0, a.d1, a.d2, a.D);
    float* mine = a.partials + (size_t)blockIdx.x * np;
    for (size_t e = tid; e < np; e += NT) mine[e] = 0.f;
    pg = partial_layout(mine, a.d0, a.d1, a.d2, a.D);
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

    // ---- sampling step: Hebbian gradients from H, E and S of the state
    // before the update; the barrier keeps the backward pass off H
    if (a.partials != nullptr &&
        (warm ? (a.pg_warm && s == a.warm_T - 1) : t >= a.mixing)) {
      prior_bias_accumulate<R>(pg.gb0, E, a.d0, nvalid, tid);
      hebbian_accumulate<R>(pg.gw1, pg.gb1, H, E + c1 * R, a.d0, a.d1, -1.f, nvalid, tid);
      hebbian_accumulate<R>(pg.gw2, pg.gb2, H + c1 * R, E + c2 * R, a.d1, a.d2, -1.f, nvalid, tid);
      if (has_s)
        hebbian_accumulate<R>(pg.gw3, pg.gb3, H + c2 * R, S, a.d2, a.D, 1.f, nvalid, tid);
      __syncthreads();
    }

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

// out[e] = partials[0][e] + partials[1][e] + ..., blocks taken in order
__global__ void sum_partials_kernel(const float* __restrict__ partials,
                                    float* __restrict__ out, int nblocks, size_t n) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = partials[e];
  for (int b = 1; b < nblocks; ++b) s += partials[(size_t)b * n + e];
  out[e] = s;
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
// partial sums when want_scalars.  With partials not null (room for
// [n_blocks, d0 d1 + d1 d2 + d2 D + d0 + d1 + d2 + D] floats, n_blocks =
// ceil(B / rows)) every block leaves there its share of the parameter
// gradients, [gW1 | gW2 | gW3 | gb0 | gb1 | gb2 | gb3], taken on Langevin
// steps t >= mixing and, with pg_warm, on the last warm step.  Returns a
// cudaError_t (0 on success).
int mcpc_chain_launch(
    const float* x0, const float* x1, const float* x2,
    float* o0, float* o1, float* o2,
    const float* y,
    const float* b0, const float* b1, const float* b2, const float* b3,
    const float* w1, const float* w2, const float* w3,
    const float* w1t, const float* w2t, const float* w3t,
    double* scal, float* partials,
    int B, int d0, int d1, int d2, int D,
    int T, int warm_T, int loss, int want_scalars, int mixing, int pg_warm,
    int rows,
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
  a.partials = partials;
  a.mixing = mixing; a.pg_warm = pg_warm;
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

// out[n] = the sum over blocks, in block order, of partials[nblocks, n]
int mcpc_sum_partials_launch(const float* partials, float* out, int nblocks,
                             size_t n, void* stream) {
  if (nblocks <= 0 || n == 0) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((n + NT - 1) / NT);
  sum_partials_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(partials, out, nblocks, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
