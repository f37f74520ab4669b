// The unpacked MCPC Langevin chain for Hopper (sm_90a).
//
// Replaces: the JAX package's ops/pallas_mcpc.py::_make_kernel (launched by
// mcpc_chain_pallas(packed=False) at its second pl.pallas_call): relu only,
// no warm phase, no scalars, no options, one batch tile; sensory loss
// bernoulli, gaussian or none; Hebbian parameter gradients over the steps
// t >= mixing.  Its step is the packed kernel's Langevin step:
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
// with the noise of _normals: step t reads draws 6t+{0,1} for x0, 6t+{2,3}
// for x1, 6t+{4,5} for x2, over a [B, half] grid with half = (d_l + 1) / 2
// and the seed unshifted (mcpc_cluster.cuh, "Noise indexing").
//
// bf16 products (the JAX kernel's bf16_matmul: its mm rounds both operands
// of every product): the build with -DMCPC_BF16 runs them as the packed
// kernel does (mcpc_cluster.cuh, "bf16 products"), on the tensor cores: the
// weights rounded once, by the wrapper, and kept as bf16 slices; h_l and
// err1, err2 and s kept as bf16 copies beside the f32 values.  err_l and s
// themselves, the bias gradients and the update stay f32.
//
// Bound on an H100: operations, as the packed kernel (4*B*(d0 d1 + d1 d2 +
// d2 D) FLOP a step, plus half of that on a step that samples).
//
// Design: the cluster kernel of mcpc_cluster.cuh with the unpacked noise
// indexing.  A cluster of 8 blocks runs the whole chain for a group of rows
// (the wrapper's chain_plan: 15 clusters of 18 rows at B=256, 120 SMs, one
// wave); the blocks split every layer by output column and keep their
// weight slices in shared memory; the backward partials go through
// distributed shared memory and are added in rank order; the step's normals
// are drawn between the arrive and the wait of the cluster barriers.  The
// gradient slice of a block stays in shared memory where it fits
// (20-128-128-784) and is read-modify-written through L2 where it does not
// (10-256-256-784); each cluster zeroes and fills its own partial, and the
// packed library's summing pass adds them in cluster order, so repeats give
// the same bits.  Only the relu instantiation without options is built:
// four kernels a library, one a row count.  No --use_fast_math.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mcpc_cluster.cuh"

namespace {

using namespace mcpc;

template <int RG>
cudaError_t launch_rows(const ChainArgs& a, size_t smem, cudaStream_t stream) {
  return launch_kernel<RG, false, ACT_RELU, NOISE_UNPACKED>(a, smem, stream);
}

}  // namespace

extern "C" {

// dynamic shared memory of one block of a cluster of `rows` rows; grads: 0
// no parameter gradients, 1 the block's gradient slice in device memory, 2
// in shared memory
size_t mcpc_chain_unpacked_smem_bytes(int d0, int d1, int d2, int D, int rows, int grads) {
  return make_layout<kBF16>(d0, d1, d2, D, rows, 0, grads, 0).total * sizeof(float);
}

// dynamic shared memory a block may use on `device`, or -1
int mcpc_chain_unpacked_smem_budget(int device) {
  return smem_budget<NOISE_UNPACKED>(device);
}

// clusters of `rows` rows with `smem` bytes of dynamic shared memory a block
// that the current device can run at once; negative: minus a cudaError_t
int mcpc_chain_unpacked_max_clusters(int rows, size_t smem) {
  switch (rows) {
#define MCPC_CASE(R) case R: return max_clusters<R / 2, NOISE_UNPACKED>(smem);
    MCPC_CLUSTER_ROWS(MCPC_CASE)
#undef MCPC_CASE
    default: return -(int)cudaErrorInvalidValue;
  }
}

const char* mcpc_chain_unpacked_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Runs T Langevin steps for every batch row, one cluster per `rows` rows.
// All pointers but `slices` are device pointers.  `slices` and `smem_bytes`
// are the plan's, as mcpc_chain_launch takes them (a launch whose plan and
// kernel disagree is refused with cudaErrorInvalidValue).  With partials
// not null (room for [ceil(B / rows), d0 d1 + d1 d2 + d2 D + d0 + d1 + d2 +
// D] floats) every cluster leaves there its share of the parameter
// gradients, [gW1 | gW2 | gW3 | gb0 | gb1 | gb2 | gb3], taken on steps
// t >= mixing; grads_resident keeps a block's slice in shared memory until
// the end.  loss: 0 none, 1 bernoulli, 2 gaussian.  In the bf16 build w1..w3
// must be rounded to bf16 already.  Returns a cudaError_t (0 on success).
int mcpc_chain_unpacked_launch(
    const float* x0, const float* x1, const float* x2,
    float* o0, float* o1, float* o2,
    const float* y,
    const float* b0, const float* b1, const float* b2, const float* b3,
    const float* w1, const float* w2, const float* w3,
    float* partials, const int* slices,
    int B, int d0, int d1, int d2, int D,
    int T, int loss, int mixing, int rows, int grads_resident,
    float inv_var, float lr, float noise_std,
    int seed, size_t smem_bytes, void* stream) {
  if (B <= 0 || d0 <= 0 || d1 <= 0 || d2 <= 0 || D <= 0 || T < 0 ||
      loss < 0 || loss > 2 || slices == nullptr)
    return (int)cudaErrorInvalidValue;
  ChainArgs a{};
  a.B = B; a.d0 = d0; a.d1 = d1; a.d2 = d2; a.D = D;
  if (!set_slices(a, slices)) return (int)cudaErrorInvalidValue;
  const size_t smem = mcpc_chain_unpacked_smem_bytes(
      d0, d1, d2, D, rows, partials == nullptr ? 0 : grads_resident ? 2 : 1);
  if (smem != smem_bytes) return (int)cudaErrorInvalidValue;
  a.x0 = x0; a.x1 = x1; a.x2 = x2;
  a.o0 = o0; a.o1 = o1; a.o2 = o2;
  a.y = y;
  a.b0 = b0; a.b1 = b1; a.b2 = b2; a.b3 = b3;
  a.w1 = w1; a.w2 = w2; a.w3 = w3;
  a.partials = partials;
  a.mixing = mixing;
  a.grads_resident = grads_resident;
  a.T = T; a.loss = loss;
  a.inv_var = inv_var; a.lr = lr; a.noise_std = noise_std;
  a.seed = seed;   // the unpacked noise reads no tile and no padded layout
  cudaStream_t st = (cudaStream_t)stream;
  switch (rows) {
#define MCPC_CASE(R) case R: return (int)launch_rows<R / 2>(a, smem, st);
    MCPC_CLUSTER_ROWS(MCPC_CASE)
#undef MCPC_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
