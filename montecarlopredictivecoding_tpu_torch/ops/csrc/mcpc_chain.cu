// The packed MCPC chain for Hopper (sm_90a) and the pass that sums its
// partial gradients.
//
// Replaces: the JAX package's ops/pallas_mcpc.py::_make_packed_kernel
// (launched by mcpc_chain_pallas(packed=True) at its pl.pallas_call) with
// every option, and the accumulators it carries across batch tiles
// (pl.when(tile_i == 0)), here a second pass, sum_partials_kernel.
//
// The chain kernel is the cluster kernel of mcpc_cluster.cuh (what it
// computes, its bound on an H100, its design and its options are described
// there), instantiated with the packed noise indexing for every row count of
// MCPC_CLUSTER_ROWS, with and without the options' code (OPT), relu and tanh
// (ACT): 16 kernels a library, f32 products here and bf16 ones on the
// tensor cores in the build with -DMCPC_BF16.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mcpc_cluster.cuh"

namespace {

using namespace mcpc;

// ------------------------------------------------------- summing pass
//
// out[e] = p[0][e] + p[1][e] + ..., partials taken in order.  A thread owns
// one element of type T (a float4 of floats, one float, or one double: the
// per-step scalar slots) and starts the loads of SUM_U partials before the
// first add, so SUM_U loads are in flight per thread instead of one.

constexpr int SUM_U = 16;

__device__ __forceinline__ float add_in_order(float s, float v) { return s + v; }
__device__ __forceinline__ double add_in_order(double s, double v) { return s + v; }
__device__ __forceinline__ float4 add_in_order(float4 s, float4 v) {
  return make_float4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
}

template <typename T>
__global__ void __launch_bounds__(NT) sum_partials_kernel(
    const T* __restrict__ partials, T* __restrict__ out, int nblocks, size_t n) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  T s = __ldg(partials + e);
  for (int b = 1; b < nblocks; b += SUM_U) {
    T v[SUM_U];
#pragma unroll
    for (int u = 0; u < SUM_U; ++u)
      if (b + u < nblocks) v[u] = __ldg(partials + (size_t)(b + u) * n + e);
#pragma unroll
    for (int u = 0; u < SUM_U; ++u)
      if (b + u < nblocks) s = add_in_order(s, v[u]);
  }
  out[e] = s;
}

// ------------------------------------------------------------ launches

template <int RG, int ACT>
cudaError_t launch_opt(const ChainArgs& a, size_t smem, cudaStream_t stream) {
  const bool opt = a.traj != nullptr || a.slots != nullptr || a.mask_lo > 0 ||
                   a.m_in != nullptr || a.m_out != nullptr || a.x3 != nullptr;
  return opt ? launch_kernel<RG, true, ACT, NOISE_PACKED>(a, smem, stream)
             : launch_kernel<RG, false, ACT, NOISE_PACKED>(a, smem, stream);
}

template <int RG>
cudaError_t launch_rows(const ChainArgs& a, size_t smem, cudaStream_t stream, int act) {
  return act == ACT_TANH ? launch_opt<RG, ACT_TANH>(a, smem, stream)
                         : launch_opt<RG, ACT_RELU>(a, smem, stream);
}

}  // namespace

extern "C" {

// blocks a cluster
int mcpc_chain_cluster_size() { return CS; }

// parts of a step that ChainArgs::clocks tells apart
int mcpc_chain_phase_count() { return N_PHASE; }

// threads a block of this build's chain kernels (both sources)
int mcpc_chain_block_threads() { return kBF16 ? NT : NT_F32; }

#ifdef MCPC_WARP_CLOCKS
// int64 numbers a block's row of `clocks` holds after the phases in this
// profiling build: WARP_CLOCKS for every warp of the f32 kernel
int mcpc_chain_warp_clock_count() { return kBF16 ? 0 : WARP_CLOCKS * (NT_F32 / 32); }
#endif

// dynamic shared memory of one block of a cluster of `rows` rows; grads: 0
// no parameter gradients, 1 the block's gradient slice in device memory, 2
// in shared memory; outpc: an output-PC site
size_t mcpc_chain_smem_bytes(int d0, int d1, int d2, int D, int rows, int warm,
                             int grads, int outpc) {
  return make_layout<kBF16>(d0, d1, d2, D, rows, warm, grads, outpc).total * sizeof(float);
}

// dynamic shared memory a block may use on `device`, or -1
int mcpc_chain_smem_budget(int device) { return smem_budget<NOISE_PACKED>(device); }

// clusters of `rows` rows with `smem` bytes of dynamic shared memory a block
// that the current device can run at once; negative: minus a cudaError_t
int mcpc_chain_max_clusters(int rows, size_t smem) {
  switch (rows) {
#define MCPC_CASE(R) case R: return max_clusters<R / 2, NOISE_PACKED>(smem);
    MCPC_CLUSTER_ROWS(MCPC_CASE)
#undef MCPC_CASE
    default: return -(int)cudaErrorInvalidValue;
  }
}

const char* mcpc_chain_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Runs warm_T Adam steps then T Langevin steps for every batch row, one
// cluster per `rows` rows.  All pointers but `slices` are device pointers.
// `slices` is the plan's cut of the layers, 4 x (cluster size + 1) ints on
// the host: for x0, x1, x2 and the output, the first column of every rank's
// slice and, last, the layer's width.  `smem_bytes` is the dynamic shared
// memory the plan expects a block to take: a launch whose plan and kernel
// disagree on it, or whose slices do not cut the layers in order into parts
// of at most ceil(d / cluster size) columns, is refused with
// cudaErrorInvalidValue.  scal receives [n_clusters * cluster size, 2]
// (loss, energy) partial sums when want_scalars.  With partials not null
// (room for [n_clusters, d0 d1 + d1 d2 + d2 D + d0 + d1 + d2 + D] floats,
// n_clusters = ceil(B / rows)) every cluster leaves there its share of the
// parameter gradients, [gW1 | gW2 | gW3 | gb0 | gb1 | gb2 | gb3], taken on
// Langevin steps t >= mixing and, with pg_warm, on the last warm step;
// grads_resident keeps a block's slice in shared memory until the end.  With
// clocks not null (room for [n_clusters * cluster size, 6] 64-bit integers)
// every block leaves there the SM clocks its thread 0 spent in each part of
// the steps.  act: 0 relu, 1 tanh.  The options (mcpc_cluster.cuh): m_in /
// v_in resume the Adam moments ([B, XW], XW the 128-padded packed width) with the bias powers
// starting at (b1p0, b2p0); m_out / v_out receive them after the warm phase;
// traj ([ceil(steps / cap_stride), B, XW], steps = T, or warm_T when T == 0)
// receives the pre-update latents every cap_stride steps; slots
// ([n_clusters * cluster size, n_slots, 2]) the per-step (loss, energy) sums
// every scal_stride steps plus the last step's in slot n_slots - 1, instead
// of scal; output columns below mask_lo are not clamped.  With x3 not null
// the model has an output-PC site: x3 ([B, D]) is its latent, o3 receives
// it, inv_var is its 1 / variance, the loss must be none (0) and mask_lo 0;
// m3_in / v3_in, m3_out / v3_out ([B, pD], pD = D padded to 128) go with
// m_in / v_in, m_out / v_out, and traj3 ([n_cap, B, pD]) with traj.  In the
// bf16 build w1..w3 must be rounded to bf16 already.
// Returns a cudaError_t (0 on success).
int mcpc_chain_launch(
    const float* x0, const float* x1, const float* x2,
    float* o0, float* o1, float* o2,
    const float* y,
    const float* b0, const float* b1, const float* b2, const float* b3,
    const float* w1, const float* w2, const float* w3,
    double* scal, float* partials, long long* clocks,
    const float* m_in, const float* v_in, float* m_out, float* v_out,
    float* traj, double* slots,
    const float* x3, float* o3, const float* m3_in, const float* v3_in,
    float* m3_out, float* v3_out, float* traj3,
    const int* slices,
    int B, int d0, int d1, int d2, int D,
    int T, int warm_T, int loss, int want_scalars, int mixing, int pg_warm,
    int rows, int grads_resident,
    int cap_stride, int scal_stride, int n_slots, int mask_lo, int act,
    float inv_var, float lr, float noise_std,
    float warm_lr, float wb1, float wb2, float one_m_b1, float one_m_b2,
    float weps, float b1p0, float b2p0,
    int seed, int tile_B, size_t smem_bytes, void* stream) {
  if (B <= 0 || d0 <= 0 || d1 <= 0 || d2 <= 0 || D <= 0 || T < 0 ||
      warm_T < 0 || tile_B <= 0 || loss < 0 || loss > 2 || slices == nullptr ||
      mask_lo < 0 || mask_lo >= D || (act != ACT_RELU && act != ACT_TANH))
    return (int)cudaErrorInvalidValue;
  // each option needs what it works on
  if ((traj != nullptr && (cap_stride <= 0 || T + warm_T == 0)) ||
      (slots != nullptr && (scal_stride <= 0 || n_slots < 1 || !want_scalars)) ||
      ((m_in != nullptr || m_out != nullptr) && warm_T == 0) ||
      ((m_in == nullptr) != (v_in == nullptr)) || ((m_out == nullptr) != (v_out == nullptr)))
    return (int)cudaErrorInvalidValue;
  // the output-PC site's arrays come with the site and with their options
  const bool outpc = x3 != nullptr;
  if ((outpc && (o3 == nullptr || loss != 0 || mask_lo != 0)) ||
      (!outpc && (o3 != nullptr || traj3 != nullptr || m3_in != nullptr ||
                  v3_in != nullptr || m3_out != nullptr || v3_out != nullptr)) ||
      (outpc && ((traj == nullptr) != (traj3 == nullptr) ||
                 (m_in == nullptr) != (m3_in == nullptr) ||
                 (v_in == nullptr) != (v3_in == nullptr) ||
                 (m_out == nullptr) != (m3_out == nullptr) ||
                 (v_out == nullptr) != (v3_out == nullptr))))
    return (int)cudaErrorInvalidValue;
  ChainArgs a;
  a.B = B; a.d0 = d0; a.d1 = d1; a.d2 = d2; a.D = D;
  if (!set_slices(a, slices)) return (int)cudaErrorInvalidValue;
  const size_t smem = mcpc_chain_smem_bytes(
      d0, d1, d2, D, rows, warm_T > 0,
      partials == nullptr ? 0 : grads_resident ? 2 : 1, outpc);
  if (smem != smem_bytes) return (int)cudaErrorInvalidValue;
  a.x0 = x0; a.x1 = x1; a.x2 = x2;
  a.o0 = o0; a.o1 = o1; a.o2 = o2;
  a.y = y;
  a.b0 = b0; a.b1 = b1; a.b2 = b2; a.b3 = b3;
  a.w1 = w1; a.w2 = w2; a.w3 = w3;
  a.scal = scal;
  a.partials = partials;
  a.clocks = clocks;
  a.mixing = mixing; a.pg_warm = pg_warm;
  a.grads_resident = grads_resident;
  a.T = T; a.warm_T = warm_T; a.loss = loss; a.want_scalars = want_scalars;
  a.inv_var = inv_var; a.lr = lr; a.noise_std = noise_std;
  a.warm_lr = warm_lr; a.wb1 = wb1; a.wb2 = wb2;
  a.one_m_b1 = one_m_b1; a.one_m_b2 = one_m_b2; a.weps = weps;
  a.seed = seed; a.tile_B = tile_B;
  a.O1 = pad128(d0);
  a.O2 = a.O1 + pad128(d1);
  a.XW = a.O2 + pad128(d2);
  a.m_in = m_in; a.v_in = v_in; a.m_out = m_out; a.v_out = v_out;
  a.traj = traj; a.slots = slots;
  a.cap_stride = cap_stride; a.scal_stride = scal_stride; a.n_slots = n_slots;
  a.mask_lo = mask_lo;
  a.b1p0 = b1p0; a.b2p0 = b2p0;
  a.x3 = x3; a.o3 = o3; a.m3_in = m3_in; a.v3_in = v3_in;
  a.m3_out = m3_out; a.v3_out = v3_out; a.traj3 = traj3;
  a.pD = pad128(D);
  cudaStream_t st = (cudaStream_t)stream;
  switch (rows) {
#define MCPC_CASE(R) case R: return (int)launch_rows<R / 2>(a, smem, st, act);
    MCPC_CLUSTER_ROWS(MCPC_CASE)
#undef MCPC_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

// out[n] = the sum over blocks, in block order, of partials[nblocks, n]
int mcpc_sum_partials_launch(const float* partials, float* out, int nblocks,
                             size_t n, void* stream) {
  if (nblocks <= 0 || n == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  // float4s need every row of partials and out 16-byte aligned
  const bool vec = n % 4 == 0 && ((uintptr_t)partials | (uintptr_t)out) % 16 == 0;
  if (vec) {
    const size_t n4 = n / 4;
    sum_partials_kernel<float4><<<(unsigned)((n4 + NT - 1) / NT), NT, 0, st>>>(
        reinterpret_cast<const float4*>(partials), reinterpret_cast<float4*>(out),
        nblocks, n4);
  } else {
    sum_partials_kernel<float><<<(unsigned)((n + NT - 1) / NT), NT, 0, st>>>(
        partials, out, nblocks, n);
  }
  return (int)cudaGetLastError();
}

// the same sum in double (the per-step scalar slots)
int mcpc_sum_partials_f64_launch(const double* partials, double* out, int nblocks,
                                 size_t n, void* stream) {
  if (nblocks <= 0 || n == 0) return (int)cudaErrorInvalidValue;
  sum_partials_kernel<double><<<(unsigned)((n + NT - 1) / NT), NT, 0, (cudaStream_t)stream>>>(
      partials, out, nblocks, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
