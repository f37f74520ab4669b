// The thread-block-cluster MCPC chain kernel for Hopper (sm_90a), shared by
// the two sources that instantiate it:
//  * mcpc_chain.cu, the packed kernel: the JAX package's
//    ops/pallas_mcpc.py::_make_packed_kernel (launched by
//    mcpc_chain_pallas(packed=True) at its pl.pallas_call), the warm phase
//    (warm_step: Adam MAP steps on the latents), the Langevin phase (step ->
//    eval_grads, box_muller), the final-step scalars (scal_sums) and the
//    Hebbian parameter gradients (accum_pgrads, with_pgrads / warm_pgrads,
//    summed across batch tiles), the per-step scalar slots (emit_scal_slot,
//    scalar_stride), the trajectory captures (capture_stride, the
//    make_async_copy into traj_ref), the masked losses (_loss_mask, mask_k),
//    the Adam-state hand-off (emit_warm_opt_state, warm_init with m_in / v_in
//    / bias0) and the trailing output-PC site (output_pc: sensory_s, the x3
//    steps, traj3, m3/v3).  Activation relu or tanh (act); sensory loss
//    bernoulli, gaussian or none, each optionally masked.
//  * mcpc_chain_unpacked.cu: ops/pallas_mcpc.py::_make_kernel (launched by
//    mcpc_chain_pallas(packed=False) at its second pl.pallas_call), the
//    unpacked relu Langevin chain with Hebbian gradients and no warm phase,
//    no scalars, no options and one batch tile.  Its step is the packed
//    kernel's; only the noise indexing differs (a template argument, NOISE).
//
// What it computes, per batch row (rows never read each other on this path):
//
//   err0 = x0 - b0;  err_l = x_l - (act(x_{l-1}) W_l + b_l);
//   logits = act(x2) W3 + b3;  S = sigmoid(logits) - y | (logits - y)/var | 0
//   G = [err0 | err1 | err2] - act'(x) * [err1 W1^T | err2 W2^T | -S W3^T]
//   act' = relu'(x), or 1 - H^2 from the H = tanh(x) the block holds
//   warm step:     Adam, optax operation order, bias powers carried in f32
//   Langevin step: x <- x - lr G + sqrt(lr var) z
//   sampling step (Langevin t >= mixing, or the last warm step), from the
//   state BEFORE the update, summed over the batch:
//     gW1 += -act(x0)^T err1   gW2 += -act(x1)^T err2   gW3 += act(x2)^T S
//     gb0 += -err0   gb1 += -err1   gb2 += -err2   gb3 += S
//
// With an output-PC site the sensory layer is a fourth latent x3 [B, D]
// with energy 0.5 inv_var3 |x3 - logits|^2 and no loss: S = (logits - x3)
// inv_var3 (the Gaussian form with y := x3), its energy joins the layers',
// and x3 takes the same Adam or Langevin step with the gradient -S.
//
// The noise z is the counter hash of the JAX package (_fmix32, _mock_bits,
// _uniforms, _sincos_2pi) evaluated per element, so this kernel can be held
// element by element against mcpc_chain_pallas(..., interpret=True), with
// either of the JAX kernels' indexings (NOISE):
//  * packed: at (seed + batch tile, draw, local_row * XW + 128-padded packed
//    column).  Step pair p reads draws 2p and 2p+1; step 2p takes r*cos,
//    step 2p+1 r*sin.  With an output-PC site a pair takes four draws: the
//    latents 4p and 4p+1, x3 4p+2 and 4p+3 at local_row * pD + output
//    column (pD = D padded to 128).
//  * unpacked (_normals of the JAX package, one batch tile, the seed
//    unshifted): step t reads draws 6t + 2l and 6t + 2l + 1 for latent l
//    over a [B, half] grid, half = (d_l + 1) / 2, at row * half + c for
//    column c < half (r*cos) and row * half + c - half for c >= half
//    (r*sin); c is the layer's global column, never a slice's.
// A draw depends on the global row and column only, never on which block
// computes it.
//
// Bound on an H100: operations.  One step at width 20-128-128-784 is
// 4*B*(20*128 + 128*128 + 128*784) FLOP = 122 MFLOP at B=256, so a
// T=10000 chain is 1.22 TFLOP: 18 ms at the published 67 TFLOP/s f32 of an
// H100 SXM at 700 W, and 1.2 ms at its 989 TFLOP/s of dense bf16 on the
// tensor cores (the bf16 build, "bf16 products" below).  Bytes (weights 477
// KB, latents and target) are negligible next to that.  The f32 build's
// products are FMAs on the CUDA cores: no TF32, no tensor cores.  Neither
// build uses --use_fast_math (tanhf, logf, log1pf, expf and sqrtf stay
// IEEE).  A step is a few hundred small dependent products and two
// hand-offs between the blocks, so what sets the pace is latency, not
// either peak.
//
// Design.  The chain is thousands of small dependent steps, so what it needs
// from the card is every SM at work and no trip to L2 inside a step.
//  * A thread-block cluster of CS = 8 blocks (the portable maximum) runs the
//    WHOLE chain (warm_T + T steps) for R batch rows in one launch.  An H100
//    SXM runs 15 such clusters at once (its 132 SMs come in groups, and one
//    group holds fewer than 16), so the wrapper's plan gives a cluster
//    R = 18 rows at B=256: 15 clusters, 120 SMs, one wave (and 10, 4 or 2
//    rows at smaller batches: MCPC_CLUSTER_ROWS).  Clusters never talk to
//    each other.
//  * The cluster's blocks split every layer by OUTPUT column: block k owns
//    the contiguous slice k of x0, x1, x2 and of the D output columns (the
//    plan cuts the slices and passes their bounds, ChainArgs::lo), and
//    keeps W_l[:, slice k] of every layer in its shared memory for the whole
//    chain (119,296 floats / 8 at 20-128-128-784: 66 KB with the padding of
//    slice_stride; 146 KB at 10-256-256-784; the bf16 build's slices, 38 and
//    83 KB).  Weights are read from device memory once, in the prologue.
//  * Every block holds the full act(X) of the cluster's rows, H [n][rows],
//    feature-major.  Forward is one phase with no exchange: block k computes
//    err_l[:, slice k] and S[:, slice k] of all layers from H and its own
//    weights.
//  * Backward: err_{l+1} W_{l+1}^T splits over the out-columns.  Block k
//    computes the partial sum over its own columns for ALL latent columns
//    and pushes it into the shared memory of the block that owns each latent
//    column (distributed shared memory).  Once all are in, the owner adds
//    the 8 partials in rank order (a fixed order: two runs give the same
//    bits), takes the Adam or Langevin step on its own columns of X (the
//    Box-Muller work and the Adam moments split 8 ways too) and pushes its
//    slice of the new act(X) into every block's H.
//  * The f32 build hands these over with no cluster barrier inside a step
//    (one costs over a thousand clocks: its release is a device-wide fence,
//    and every block waits for all eight where it reads some).  Each block
//    holds two mbarriers (Layout::MB), whose phase s is step s's:
//    - P_bar, the partials are in.  A partial is pushed by st.async
//      (mbarrier::complete_tx::bytes) into the owner's P, its bytes counted
//      on the owner's P_bar.  After a __syncthreads that ends the backward,
//      one thread a peer makes one remote arrive.release.cluster on that
//      peer's P_bar.  A phase takes CS arrivals, the block's own arming it
//      with the bytes the eight ranks push into it (CS x its own columns
//      with partials x R floats), and completes when all have landed.
//    - H_bar, act(x) is in.  The owner pushes each new act(x) into every
//      block's H by st.async, counted on that block's H_bar, whose one
//      arrival is the block's own, armed with n x R floats.
//    A block waits (try_wait.parity.acquire.cluster) on its P_bar before
//    the update reads P and, after a __syncthreads, on its H_bar before the
//    next forward reads H.  The hazards the barriers covered:
//    - write after read on H: a peer's update(s) writes this block's H only
//      after its P_bar(s) completes, which takes this block's arrival, made
//      after the __syncthreads behind this block's forward, Hebbian and
//      backward reads of H (a warp may push no partial to a given owner,
//      so the pushes alone would not order its reads);
//    - write after read on P: a peer pushes P(s+1) after its forward(s+1),
//      so after its H_bar(s) completes, which takes every act(x) this block
//      pushes in update(s), each pushed by its thread after that thread's
//      last read of P;
//    - phase aliasing: no step s+1 byte can land in a step s phase.  P(s+1)
//      takes H(s), which this block pushes only after its P_bar(s)
//      completed; H(s+1) takes the owner's P_bar(s+1), which takes this
//      block's arrival of step s+1, made after its H_bar(s) wait.  A block
//      arms both phases of step s before the __syncthreads that precedes
//      its arrivals, so before any peer can push it act(x); partials may
//      land before the arm (a transaction count may go below zero), and
//      the phase still waits for the arm, an arrival;
//    - inside the block, the __syncthreads before the H_bar wait orders the
//      update's and the x3 step's reads and writes (X, E, S, X3, P) before
//      the next step's forward.
//    So P and H keep one buffer each.  Per f32 step: three __syncthreads
//    and two mbarrier waits; the prologue's cluster.sync and one cluster
//    barrier before the epilogue (no peer may write into a block that has
//    exited) are the kernel's only cluster barriers.  A wait that lasts
//    HANDOFF_TRAP_CLOCKS traps: a byte count that does not match the
//    pushes fails the launch instead of hanging the card.
//  * The bf16 build keeps the cluster barriers: its act(x) copies (H16) are
//    2-byte stores, and st.async has no 16-bit form.  A cluster barrier
//    after the backward's remote stores, a second one after the update ends
//    the step; each is split into arrive and wait.
//  * The noise needs no memory: the step's normals are drawn between the
//    backward's last push and the P_bar wait (bf16: between the first
//    barrier's arrive and wait), the next step's first ones before the
//    H_bar wait (bf16: inside the second barrier).
//  * The f32 build's products wait on the SM's shared-memory loads, not on
//    the FMA pipe, so a lane keeps a register tile of 4 neighbouring columns
//    by half of the rows (forward) or 4 columns by all the rows (backward,
//    gradients), reads its operands as float4s, and 4 lanes share a tile
//    and split its k; the warps deal the tiles in rounds of one sum length
//    ("products" below; the bf16 build's run on the tensor cores: "bf16
//    products").
//  * Every block of a cluster reaches every barrier: pad rows (beyond B)
//    evolve like real rows and are skipped only in sums and stores.
//
// Parameter gradients.  gW_l[:, slice k] = H_{l-1}^T err_l[:, slice k] needs
// the full H and the block's own error slice, both already in the block: no
// exchange, no atomics, and each block owns a fixed slice of its cluster's
// partial [gW1 | gW2 | gW3 | gb0 | gb1 | gb2 | gb3].  Where it fits (the
// wrapper's plan decides; it does at 20-128-128-784) the slice stays in
// shared memory for the whole chain and is written once at the end;
// otherwise each thread read-modify-writes its own elements of the partial
// in device memory.  A second kernel, sum_partials_kernel, adds the
// clusters' partials in cluster order.  Rows that only pad the last cluster
// are skipped in every sum.
//
// Options.  Each is a branch on a ChainArgs field (a null pointer or 0 means
// off).  Every option also sits behind a template flag, OPT, and the launch
// picks the instantiation, so a chain that uses none runs the kernel without
// their code.  With runtime branches only, ptxas showed no spill and about
// the same registers, yet such chains ran 5-6% slower (B=256, T=10000:
// 122.6-123.5 against 116.5-116.6 ms in one chip_smoke.py call on an NVIDIA
// H100 80GB HBM3 at 700 W); with the step loop's options behind the flag and
// the Adam state's loads and stores still runtime branches, 1-3% slower
// (119.2-120.3 against 117.5-118.4 ms, another call; the forward pass took 4%
// more SM clocks).  Code that never runs still costs.
//  * Captures: at every step of the captured phase (the Langevin phase, or
//    the warm phase when T == 0) with t % cap_stride == 0, before the update,
//    each block stores its own columns of X for its valid rows into
//    traj[t / cap_stride][row][padded column], the JAX layout; the wrapper
//    zeroes the pad lanes.  X is stable there (the step before has ended,
//    and this block writes X only in this step's update).
//  * Per-step scalars: on a slot step (t % scal_stride == 0 in the same
//    phase) and on the last step, every block sums the loss and energy of its
//    own columns and valid rows in double, warps by shuffle, then thread 0
//    over the warps in order, behind the __syncthreads that already ends the
//    forward pass; it writes the pair to slots[block][slot].  The wrapper adds
//    the blocks in block order (sum_partials_kernel<double>): no atomics.
//  * Masked losses: the owner of output column j zeroes S and the loss term
//    unless j >= mask_lo (D - mask_k, or 0 for "all columns").
//  * Adam state: with m_in / v_in the prologue loads the own columns'
//    moments instead of zeros, and the bias powers start at (b1p0, b2p0),
//    computed by the host; with m_out / v_out the epilogue stores them.
//  * Output-PC site (x3 not null): the owner of output column j keeps x3[:, j]
//    (and in the warm phase its Adam moments) in shared memory beside its
//    S.  Nothing else reads them, so its update needs no exchange: it runs
//    between the backward's last push and the P_bar wait (bf16: between
//    the arrive and the wait of the step's first cluster barrier), from the
//    S of this step, as the latents' noise does.  Captures go to
//    traj3 [n_cap, B, pD], the moments to m3 / v3 [B, pD], pad lanes zeroed
//    by the wrapper; the loss is "none" and no mask applies.
//  Every block reaches every barrier as before: none of these adds a
//  barrier or a rank-dependent exit, and pad rows are skipped in stores.
//
// Activation.  A template argument, ACT, picks relu or tanh, so a
// relu chain runs the code it ran before tanh existed.  tanh is tanhf, and
// its derivative 1 - H^2 is taken from the H = tanh(x) every block holds.
//
// bf16 products (the JAX kernel's bf16_matmul).  A fourth template argument,
// BF16, which only the library built with -DMCPC_BF16 instantiates (it sets
// kBF16, mcpc_common.cuh): the f32 library carries none of its code, and
// the two build side by side.  Every product takes bf16 operands, rounded to
// nearest even, and sums in f32 on the tensor cores, as the JAX kernel's mm
// / mmT with preferred_element_type=f32 do on the MXU: mma.sync m16n8k16
// (m16n8k8 for a last 8 rows) with f32 accumulators, its operands read from
// shared memory by ldmatrix ("tensor-core tiles" below).
//  * Operands live in shared memory as bf16, feature-major with the rows
//    contiguous: act(X) of every latent column (H16, each layer's columns
//    padded to 16), the own columns' err1, err2 and S (E16, rounded as the
//    forward pass makes them), and the weight slices W_l[:, slice k] (rounded
//    once by the wrapper, stored once).  A row of these arrays holds the
//    cluster's rows padded to whole n8 tiles (24 for 18 rows), at a pitch of
//    8 * odd bf16, so the 8 rows an ldmatrix reads fall in 8 different
//    16-byte bank groups.  Every pad (rows of a layer, columns of a slice,
//    rows of the cluster) is zero from the prologue on, and H16 and E16 hold
//    zero at rows beyond the batch, so a padded sum adds exact zeros.
//  * The rows take the narrow side of each product (N: 18 rows pad to 24,
//    not to 32 as M would): forward err^T[slice][rows] = W_slice^T H16
//    (ldmatrix.trans of the weights), backward partial^T[in][rows] = W E16^T,
//    Hebbian gW[in][slice] += H16 E16^T with K = rows and the C fragment read
//    from and written back to the f32 gradient slice.  One weight slice
//    serves both: the forward product reads it transposed.
//  * A warp takes a whole tile: 16 output columns (or 16 latent columns, or
//    16 input features of a gradient) by all the rows.  The warps deal the
//    tiles in snake order, longest first (snake_tile), so that at
//    20-128-128-784 the forward's two short tiles (err2, err1) share one
//    warp.  The forward and backward products load the next k step's
//    fragments while this one multiplies, and sum the k steps in order; a
//    Hebbian warp loads its A fragments once and walks the own columns 8 at
//    a time, each 8 loading the next 8's running sums first.
//  * The epilogues read the D fragments: the errors, S, the loss and energy
//    sums, and the partials' DSMEM stores into the owner's P at this rank.
//    The forward's computes every element of a tile branch-free (indices
//    clamped) before it stores the real ones, and loads the target before
//    the products; the rare double-precision loss sums are out of line
//    (loss_term).  The rank-order sum, the update and everything else is
//    the f32 code.
//  * What a bf16 step costs (chip_smoke.py phase 6, PERF.md): the products
//    are a small part of it; each tile's epilogue, issued by two warps a
//    scheduler, and the two cluster barriers are most of it.
//  * act' is taken from the unrounded x: 1 - tanh(x)^2 is recomputed by the
//    owner from its own x, since the H16 it holds is rounded;
//  * errors, S, the bias gradients, the scalars, the Adam state, the x3 step,
//    the noise and the partials P stay f32.
// The product of two bf16 values is exact in f32, so the products differ
// from the plain version's only in the order (and the tensor cores'
// rounding) of the f32 sums.

// Noise indexing.  A fifth template argument, NOISE, picks the packed or the
// unpacked indexing inside the one function that computes an element's
// normal (the latents' noise lambda, also used for the draws ahead of a
// step).  mcpc_chain.cu instantiates only NOISE_PACKED and
// mcpc_chain_unpacked.cu only NOISE_UNPACKED (with OPT false and relu), so
// neither library carries the other's code: a runtime branch on the options
// cost 5-6% (Options above).  Pad rows draw noise too; nothing reads it.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mcpc_common.cuh"

namespace mcpc {

namespace cg = cooperative_groups;

constexpr int CS = 8;             // blocks a cluster
// Threads a block of the f32 build, a constant of its own beside the bf16
// build's NT.  A block of 512 (128 registers a thread) or 384 (168) spills
// the products' register tiles; 256 (255 registers) holds them, so the f32
// build runs 256 too (PERF.md, Findings).
constexpr int NT_F32 = 256;

// Rows a cluster for which the kernel is built (CLUSTER_ROWS of the wrapper,
// whose plan picks among them): each is four instantiations in the packed
// library (with and without the options, relu and tanh) and one in the
// unpacked library, of 200 to 255 registers a thread, so the list is kept to
// what the plan's rule needs.
#define MCPC_CLUSTER_ROWS(X) X(18) X(10) X(4) X(2)
constexpr int PG_ROWS = 16;       // rows of gW one gradient job covers
constexpr int ACT_RELU = 0, ACT_TANH = 1;   // the activation, a template argument
constexpr int NOISE_PACKED = 0, NOISE_UNPACKED = 1;   // the noise indexing, another

// With ChainArgs::clocks, thread 0 of every block adds up the SM clocks it
// spends in each part of a step, waits at the barriers included: forward up
// to its barrier, gradient jobs, backward jobs, the wait for the peers'
// partials, the update, the wait for the peers' new act(x).
constexpr int N_PHASE = 6;

// Per-warp clocks, a profiling build only (-DMCPC_WARP_CLOCKS; the libraries
// the port runs never carry this code, since code that never runs still
// costs: "Options" in the header).  Lane 0 of every warp of an f32 build
// adds up, over the steps, WARP_CLOCKS numbers: the clocks from the step's
// start to its first forward job, from its first forward job to the end of
// its last, and from its first backward job to the end of its last.  They
// follow the phases in each block's row of ChainArgs::clocks.
#ifdef MCPC_WARP_CLOCKS
constexpr bool kWarpClocks = true;
#else
constexpr bool kWarpClocks = false;
#endif
constexpr int WARP_CLOCKS = 3;

struct ChainArgs {
  const float* x0; const float* x1; const float* x2;   // [B, d_l]
  float* o0; float* o1; float* o2;                     // [B, d_l]
  const float* y;                                      // [B, D]
  const float* b0; const float* b1; const float* b2; const float* b3;
  const float* w1; const float* w2; const float* w3;   // [in, out]
  double* scal;                                        // [n_blocks, 2]
  float* partials;                                     // [n_clusters, partial_floats] or null
  long long* clocks;                                   // [n_blocks, N_PHASE] or null
  int B, d0, d1, d2, D;
  int T, warm_T, loss, want_scalars;                   // loss: 0 none, 1 bernoulli, 2 gaussian
  int mixing, pg_warm;         // with partials: sample Langevin steps t >= mixing,
                               // and with pg_warm the last warm step
  int grads_resident;          // the block's gradient slice lives in shared memory
  float inv_var, lr, noise_std;
  float warm_lr, wb1, wb2, one_m_b1, one_m_b2, weps;
  int seed, tile_B, XW, O1, O2;                        // noise indexing
  int lo[4][CS + 1];           // the plan's slices of x0, x1, x2 and the output:
                               // rank k owns columns [lo[l][k], lo[l][k + 1])
  // options (see the header); aligned [B, XW] arrays are laid out as the
  // JAX package's packed latents, column c of latent l at O_l + c
  const float* m_in; const float* v_in;                // [B, XW] or null
  float* m_out; float* v_out;                          // [B, XW] or null
  float* traj;                                         // [n_cap, B, XW] or null
  double* slots;                                       // [n_blocks, n_slots, 2] or null
  int cap_stride, scal_stride, n_slots;
  int mask_lo;                 // output columns below it are not clamped
  float b1p0, b2p0;            // bias-correction powers of the first warm step
  // output-PC site: x3 in, o3 out ([B, D]); pD-wide [B, pD] arrays, as the
  // JAX package's: the moments in and out, and the captures [n_cap, B, pD]
  const float* x3; float* o3;
  const float* m3_in; const float* v3_in; float* m3_out; float* v3_out;
  float* traj3;
  int pD;
};

// ------------------------------------------------------------- slices
//
// The wrapper's plan cuts a layer of d columns into CS contiguous slices, as
// even as possible, and passes their bounds (ChainArgs::lo).  A layer
// narrower than the cluster leaves the last ranks an empty slice.  No slice
// is wider than ceil(d / CS), which sizes the shared memory.

__host__ __device__ inline int widest_slice(int d) { return (d + CS - 1) / CS; }

// Row stride, in words, of a weight slice of `width` columns: the least
// 8 * odd that holds it.  In the forward product a warp reads 4 rows
// k..k+3 at 8 neighbouring columns each: with rows 8 * odd words apart the
// 32 words lie in 32 different banks.  The backward product reads 8 rows at
// 4 neighbouring words each, two rows to a bank.
__host__ __device__ inline int slice_stride(int width) {
  const int m = (width + 7) / 8;
  return 8 * (m | 1);
}

// The R = 2 * RG rows of a cluster within one feature of a [..][rows] array.
// A forward item reads one half of the rows (RG of them): the first RG / 4 *
// 4 as float4, the rest one by one; the backward and gradient ones read all
// R positions, float4s then a float2.  So that the float4s are aligned, a feature
// holds the float4 parts of both halves first, then the leftovers of both,
// and its pitch is a multiple of 4 words (18 rows: 8 + 8 + 1 + 1, pitch 20).
__host__ __device__ constexpr int row_pitch(int R) {
  return R / 2 / 4 > 0 ? (R + 3) / 4 * 4 : R;
}

template <int RG>
struct Rows {
  static constexpr int R = 2 * RG;
  static constexpr int MAIN = RG / 4 * 4;   // rows of a half read as float4
  static constexpr int REST = RG - MAIN;
  static constexpr int PITCH = row_pitch(R);
  // where row `lr` of half `g` lies
  __device__ static constexpr int pos(int g, int lr) {
    return lr < MAIN ? g * MAIN + lr : 2 * MAIN + g * REST + lr - MAIN;
  }
  __device__ static constexpr int pos(int row) { return pos(row / RG, row % RG); }
  // the row that lies at position p < R
  __device__ static constexpr int row_at(int p) {
    constexpr int M1 = MAIN > 0 ? MAIN : 1, R1 = REST > 0 ? REST : 1;   // no x / 0
    return p < 2 * MAIN ? p / M1 * RG + p % M1
                        : (p - 2 * MAIN) / R1 * RG + MAIN + (p - 2 * MAIN) % R1;
  }
};

// The bf16 build's [..][rows] arrays (H16, E16: "bf16 products" in the
// header) hold the R rows padded to whole n8 tiles, at a pitch of 8 * odd
// bf16: the 8 rows of 16 bytes that an ldmatrix reads then lie in 8
// different 16-byte bank groups.  The rows keep the f32 arrays' positions
// (Rows<RG>::pos), so a D fragment's column is a position there too.
__host__ __device__ constexpr int rows_n8(int R) { return (R + 7) / 8 * 8; }
__host__ __device__ constexpr int bf16_pitch(int R) {
  return rows_n8(R) / 8 % 2 ? rows_n8(R) : rows_n8(R) + 8;
}
__host__ __device__ constexpr int up16(int d) { return (d + 15) / 16 * 16; }

// Shared memory of one block, in floats.  Every block of a cluster uses the
// same offsets (sized by the widest slice), so an offset means the same
// place in a peer's shared memory.
struct Layout {
  int N0, N1, N2, ND;      // widest slice of x0, x1, x2 and the output
  int J1, J2, OWN;         // where the x1 and x2 slices start among a block's
                           // own latent columns, and how many those are
  int LD1, LD2, LD3;       // row strides of the f32 weight and gradient slices (8 * odd)
  size_t H, X, E, S, P, M, V;   // [..][row_pitch(R)] arrays (BF16: H is H16)
  size_t X3, M3, V3;            // the same: an output-PC site's own columns, moments
  size_t W1, W2, W3, BI;        // weight slices, own biases [OWN + ND]
  size_t OT;                    // owner and own-column index of every latent column [n]
  size_t G1, G2, G3, GB;        // gradient slices, own bias gradients
  size_t MB;                    // f32 only: the hand-offs' barriers P_bar, H_bar (at 0)
  size_t total;
  // BF16 only (bf16 arrays; their offsets in floats, the rest in bf16):
  int HP;                  // pitch of H16 and E16: bf16_pitch(R)
  int HB1, HB2;            // H16's first rows of x1 and x2 (each layer padded to 16)
  int EB2, EBS;            // E16's first rows of err2 and S (err1 at 0; widest slices
                           // padded to 16)
  int LW1, LW2, LW3;       // row strides of the bf16 weight slices: up16(widest) + 8
  size_t E16;
};

// grads: 0 none, 1 bias gradients only (weights' in device memory), 2 all;
// outpc: an output-PC site.  BF16: the bf16 products' layout, whose bf16
// arrays (H16, E16, the weight slices, rows padded as the tiles read them)
// come first and keep every later array 16-byte aligned.
template <bool BF16 = false>
__host__ __device__ inline Layout make_layout(int d0, int d1, int d2, int D,
                                              int R, int warm, int grads, int outpc) {
  Layout L;
  L.N0 = widest_slice(d0); L.N1 = widest_slice(d1);
  L.N2 = widest_slice(d2); L.ND = widest_slice(D);
  L.J1 = L.N0; L.J2 = L.N0 + L.N1; L.OWN = L.N0 + L.N1 + L.N2;
  L.LD1 = slice_stride(L.N1); L.LD2 = slice_stride(L.N2); L.LD3 = slice_stride(L.ND);
  const size_t n = (size_t)d0 + d1 + d2;
  const size_t RP = row_pitch(R);
  size_t o = 0;
  if constexpr (!BF16) {   // the step's two mbarriers (8 bytes each) first: their
    L.MB = 0; o = 4;         // address is the array's, a constant
  }
  if constexpr (BF16) {
    L.HP = bf16_pitch(R);
    L.HB1 = up16(d0); L.HB2 = L.HB1 + up16(d1);
    L.EB2 = up16(L.N1); L.EBS = L.EB2 + up16(L.N2);
    L.LW1 = up16(L.N1) + 8; L.LW2 = up16(L.N2) + 8; L.LW3 = up16(L.ND) + 8;
    L.H = o; o += (size_t)(L.HB2 + up16(d2)) * L.HP / 2;
    L.E16 = o; o += (size_t)(L.EBS + up16(L.ND)) * L.HP / 2;
    L.W1 = o; o += (size_t)up16(d0) * L.LW1 / 2;
    L.W2 = o; o += (size_t)up16(d1) * L.LW2 / 2;
    L.W3 = o; o += (size_t)up16(d2) * L.LW3 / 2;
  } else {
    L.H = o; o += n * RP;
  }
  L.X = o; o += (size_t)L.OWN * RP;
  L.E = o; o += (size_t)L.OWN * RP;
  L.S = o; o += (size_t)L.ND * RP;
  L.P = o; o += (size_t)CS * L.OWN * RP;
  L.M = o; o += warm ? (size_t)L.OWN * RP : 0;
  L.V = o; o += warm ? (size_t)L.OWN * RP : 0;
  // with the other [..][RP] arrays, whose sizes keep them 16-byte aligned
  L.X3 = o; o += outpc ? (size_t)L.ND * RP : 0;
  L.M3 = o; o += outpc && warm ? (size_t)L.ND * RP : 0;
  L.V3 = o; o += outpc && warm ? (size_t)L.ND * RP : 0;
  if constexpr (!BF16) {
    // the weight and gradient slices (strides 8 * odd) start 16-byte
    // aligned, so their products read and write 4 neighbouring columns as a
    // float4 (at 2 rows RP = 2 and the arrays above may end 8 bytes short)
    o = (o + 3) / 4 * 4;
    L.W1 = o; o += (size_t)d0 * L.LD1;
    L.W2 = o; o += (size_t)d1 * L.LD2;
    L.W3 = o; o += (size_t)d2 * L.LD3;
    L.G1 = o; o += grads == 2 ? (size_t)d0 * L.LD1 : 0;
    L.G2 = o; o += grads == 2 ? (size_t)d1 * L.LD2 : 0;
    L.G3 = o; o += grads == 2 ? (size_t)d2 * L.LD3 : 0;
  }
  L.BI = o; o += (size_t)L.OWN + L.ND;
  L.OT = o; o += n;
  if constexpr (BF16) {
    L.G1 = o; o += grads == 2 ? (size_t)d0 * L.LD1 : 0;
    L.G2 = o; o += grads == 2 ? (size_t)d1 * L.LD2 : 0;
    L.G3 = o; o += grads == 2 ? (size_t)d2 * L.LD3 : 0;
  }
  L.GB = o; o += grads != 0 ? (size_t)L.OWN + L.ND : 0;
  L.total = o;
  return L;
}

// Standard normal of Langevin step t at element index idx: Box-Muller over
// draws DP*p + off and the next of pair p = t/2 (DP draws a pair: 2, or 4
// with an output-PC site, whose x3 takes off = 2); even steps take the cos
// branch, odd the sin.
__device__ __forceinline__ float langevin_normal(uint32_t seed, int t, uint32_t idx,
                                                 uint32_t dp = 2u, uint32_t off = 0u) {
  return box_muller(seed, (uint32_t)(t >> 1) * dp + off, idx, (t & 1) != 0);
}

template <int ACT>
__device__ __forceinline__ float activate(float x) {
  if constexpr (ACT == ACT_TANH) return tanhf(x);
  else return fmaxf(x, 0.f);
}

// The two halves of a cluster barrier.  Writes made before the arrive (a
// peer's shared memory included) are visible to every thread of the cluster
// after its wait; what lies between touches registers only.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The f32 build's hand-offs ("Design" in the header): an mbarrier in each
// block's shared memory, 32-bit shared-window addresses.  `mapa` gives the
// address of the same place in the block of cluster rank `k`.
__device__ __forceinline__ uint32_t peer_addr(uint32_t local, int k) {
  uint32_t out;   // not volatile: a pure function of its operands, which
                  // the compiler may hoist out of a loop or share
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(local), "r"(k));
  return out;
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(arrivals)
               : "memory");
}
// this block's arrival on its own barrier, which also expects `bytes` more
// in the current phase
__device__ __forceinline__ void mbar_arrive_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.release.cta.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}
// an arrival on a peer's barrier (`bar` from peer_addr) that releases this
// thread's earlier reads and writes to the cluster
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" :: "r"(bar)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}
// A wait longer than this many SM clocks (about 2 s) is a hand-off that
// will never complete (a byte count that does not match the pushes): the
// kernel traps, and the launch fails instead of hanging the card.  The
// clock is read only while the block already waits.
constexpr long long HANDOFF_TRAP_CLOCKS = 1ll << 32;
// until the phase of parity `parity` of this block's barrier `bar` is
// complete: every arrival made and every byte expected landed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > HANDOFF_TRAP_CLOCKS) __trap();
}
// st.async: v into the shared memory of a peer at `dst`, its bytes counted
// on that block's barrier `bar` (both from peer_addr)
__device__ __forceinline__ void push(uint32_t dst, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
               :: "r"(dst), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}
__device__ __forceinline__ void push(uint32_t dst, float2 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], {%1, %2}, [%3];"
      :: "r"(dst), "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void push(uint32_t dst, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];"
      :: "r"(dst), "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)),
         "r"(__float_as_uint(v.z)), "r"(__float_as_uint(v.w)), "r"(bar)
      : "memory");
}

// ------------------------------------------------------------ products
//
// The f32 build's products (the bf16 build's: "tensor-core tiles" below).
// Both products of a step are small matrix products out[col][row] =
// sum_k A[k][row] * W(k, col) whose operands lie in shared memory.  They
// wait on the shared-memory loads the SM serves, not on the FMA pipe: a k
// step costs the more clocks the more warps load at once, and a build whose
// items held 2 columns by half of the rows (5 loads for 18 FMAs, 16 warps)
// ran slower than 4 by half (7 for 36, 8 warps) (PERF.md, Findings).  So a
// lane keeps a register tile, an ITEM of 4 columns (a QUAD), and reads its
// operands as float4s:
//  * forward: 4 neighbouring own columns (one float4 of the weight slice's
//    row k) by one half of the rows, 4 loads for 36 FMAs at 18 rows, the
//    next k step's operands loading while this one's FMAs run;
//  * backward: 4 latent columns NQ apart (4 rows of the weight slice, one
//    load each) by all R rows (float4s), 9 loads for 72 FMAs;
//  * gradients (below): 4 neighbouring own columns by all R rows.
// KSPLIT lanes of a warp share an item and take every KSPLIT-th k, each
// into its own part sum from 0 in ascending k; a shuffle butterfly adds the
// four part sums as (P0 + P2) + (P1 + P3) and leaves lane part u with the
// total of column u.  Lane = item within the warp + QUADS * part.  Which
// columns and rows a lane holds does not change a sum: every element is
// summed in this order whatever the tiles, so retiling keeps the bits.
//
// A warp takes QUADS items of one sum length K at a time (a ROUND, so no
// lane waits for a longer sum: Deal), and the block's warps deal the rounds
// in snake order, longest sums first (snake_tile).

constexpr int KSPLIT = 4;           // lanes that share an item
constexpr int QUADS = 32 / KSPLIT;  // items a warp takes at once

// v = the R positions of the feature at `feature` (pitch row_pitch(R)):
// float4s, then a float2
template <int R>
__device__ __forceinline__ void load_positions(float (&v)[R], const float* feature) {
  constexpr int F4 = row_pitch(R) % 4 == 0 ? R / 4 : 0;
#pragma unroll
  for (int i = 0; i < F4; ++i) {
    const float4 x = reinterpret_cast<const float4*>(feature)[i];
    v[4 * i] = x.x; v[4 * i + 1] = x.y; v[4 * i + 2] = x.z; v[4 * i + 3] = x.w;
  }
#pragma unroll
  for (int p = 4 * F4; p < R; p += 2) {   // R is even
    const float2 x = reinterpret_cast<const float2*>(feature)[p / 2];
    v[p] = x.x; v[p + 1] = x.y;
  }
}

// the R positions of the feature at `feature` = v (it may lie in a peer's
// shared memory)
template <int R>
__device__ __forceinline__ void store_positions(float* feature, const float (&v)[R]) {
  constexpr int F4 = row_pitch(R) % 4 == 0 ? R / 4 : 0;
#pragma unroll
  for (int i = 0; i < F4; ++i)
    reinterpret_cast<float4*>(feature)[i] =
        make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
#pragma unroll
  for (int p = 4 * F4; p < R; p += 2)
    reinterpret_cast<float2*>(feature)[p / 2] = make_float2(v[p], v[p + 1]);
}

// store_positions into a block of the cluster by st.async: `feature` and
// `bar` are shared-window addresses in that block (peer_addr), and the
// block's barrier counts the 4 R bytes
template <int R>
__device__ __forceinline__ void push_positions(uint32_t feature, const float (&v)[R],
                                               uint32_t bar) {
  constexpr int F4 = row_pitch(R) % 4 == 0 ? R / 4 : 0;
#pragma unroll
  for (int i = 0; i < F4; ++i)
    push(feature + 16u * i, make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]),
         bar);
#pragma unroll
  for (int p = 4 * F4; p < R; p += 2)
    push(feature + 4u * p, make_float2(v[p], v[p + 1]), bar);
}

// v = the rows of half g of the feature at `feature`
template <int RG>
__device__ __forceinline__ void load_rows(float (&v)[RG], const float* feature, int g) {
  using RW = Rows<RG>;
#pragma unroll
  for (int i = 0; i < RW::MAIN / 4; ++i) {
    const float4 x = reinterpret_cast<const float4*>(feature + g * RW::MAIN)[i];
    v[4 * i] = x.x; v[4 * i + 1] = x.y; v[4 * i + 2] = x.z; v[4 * i + 3] = x.w;
  }
#pragma unroll
  for (int r = RW::MAIN; r < RG; ++r) v[r] = feature[RW::pos(g, r)];
}

// the rows of half g of the feature at `feature` = v
template <int RG>
__device__ __forceinline__ void store_rows(float* feature, int g, const float (&v)[RG]) {
  using RW = Rows<RG>;
#pragma unroll
  for (int i = 0; i < RW::MAIN / 4; ++i)
    reinterpret_cast<float4*>(feature + g * RW::MAIN)[i] =
        make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
#pragma unroll
  for (int r = RW::MAIN; r < RG; ++r) feature[RW::pos(g, r)] = v[r];
}

// acc[u][i] += sum over k = part, part + KSPLIT, ... < K of a_k[i] * w_k[u],
// in ascending k, where load_a(k, a_k) and load_w(k, w_k) bring row k's
// operands.  With PREFETCH the next k step's operands load while this one's
// FMAs run (the forward); without, the loop is unrolled 4 times and the
// compiler places the loads (the backward, whose 72 sums leave no room for
// a second set of operands: it ran faster so)
template <int N, bool PREFETCH, typename LoadA, typename LoadW>
__device__ __forceinline__ void quad_dot(float (&acc)[4][N], LoadA load_a, LoadW load_w,
                                         int part, int K) {
  auto fma_step = [&](const float (&av)[N], const float (&w)[4]) {
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int i = 0; i < N; ++i) acc[u][i] = fmaf(av[i], w[u], acc[u][i]);
  };
  if constexpr (PREFETCH) {
    float a0[N], w0[4], a1[N], w1[4];
    int k = part;
    if (k < K) { load_a(k, a0); load_w(k, w0); }
    for (; k + KSPLIT < K; k += 2 * KSPLIT) {
      load_a(k + KSPLIT, a1);
      load_w(k + KSPLIT, w1);
      fma_step(a0, w0);
      if (k + 2 * KSPLIT < K) {
        load_a(k + 2 * KSPLIT, a0);
        load_w(k + 2 * KSPLIT, w0);
      }
      fma_step(a1, w1);
    }
    if (k < K) fma_step(a0, w0);
  } else {
#pragma unroll 4
    for (int k = part; k < K; k += KSPLIT) {
      float av[N], w[4];
      load_a(k, av);
      load_w(k, w);
      fma_step(av, w);
    }
  }
}

// Adds the KSPLIT lanes' part sums of one item.  Afterwards out[] of the
// lane with part u holds the total of column u: (P0 + P2) + (P1 + P3).
// Every lane of the warp must call it.
template <int N>
__device__ __forceinline__ void quad_reduce(float (&out)[N], const float (&acc)[4][N],
                                            int lane) {
  static_assert(KSPLIT == 4, "lane bits 16 and 8 are the part and pick the column");
  const bool hi = (lane & 16) != 0, mid = (lane & 8) != 0;
  float half[2][N];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int p = 0; p < N; ++p)
      half[u][p] = (hi ? acc[u + 2][p] : acc[u][p]) +
                   __shfl_xor_sync(0xffffffffu, hi ? acc[u][p] : acc[u + 2][p], 16);
#pragma unroll
  for (int p = 0; p < N; ++p) {
    out[p] = (mid ? half[1][p] : half[0][p]) +
             __shfl_xor_sync(0xffffffffu, mid ? half[0][p] : half[1][p], 8);
  }
}

// How a product's items are dealt: they come in three classes (in the
// forward the quads of the own S, err2 and err1 columns, K = d2, d1, d0; in
// the backward those of the x2, x1 and x0 columns, K = the own output, x2
// and x1 columns), laid out in that order on slots, QUADS slots a round.  A
// class whose K differs from the one before starts a new round, so the
// items of a round share K; classes of equal K share rounds.
struct Deal {
  int base[3], n[3], rounds;
  __device__ __forceinline__ Deal(int n0, int K0, int n1, int K1, int n2, int K2) {
    const int counts[3] = {n0, n1, n2}, Ks[3] = {K0, K1, K2};
    int slot = 0;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (c > 0 && Ks[c] != Ks[c - 1]) slot = (slot + QUADS - 1) / QUADS * QUADS;
      base[c] = slot;
      n[c] = counts[c];
      slot += counts[c];
    }
    rounds = (slot + QUADS - 1) / QUADS;
  }
  // the class of the item at `slot` and its index there, or -1 (no item)
  __device__ __forceinline__ int cls(int slot, int& idx) const {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      if (slot >= base[c] && slot < base[c] + n[c]) {
        idx = slot - base[c];
        return c;
      }
    idx = 0;
    return -1;
  }
};

// ------------------------------------------------ tensor-core tiles
//
// The bf16 build's products (BF16; "bf16 products" in the header), one warp
// a tile: mma.sync m16n8k16 (and m16n8k8 for a last 8 of K) with bf16
// operands and f32 accumulators.  A lane is (gq, tq) = (lane / 4, lane % 4)
// in the fragments: an accumulator acc[4] of a 16 x 8 tile holds rows gq
// (acc[0], acc[1]) and gq + 8 (acc[2], acc[3]) at columns 2 tq and 2 tq + 1.
// The operands come from feature-major bf16 arrays in shared memory through
// ldmatrix, whose lane l gives the address of row l % 8 of 8 x 8 matrix
// l / 8; .trans hands each lane a column pair instead of a row pair.

using bf16_t = __nv_bfloat16;

// The tile a warp takes at its turn-th turn when a block's NW warps deal `count` tiles in
// snake order (warp w: w, 2 NW - 1 - w, 2 NW + w, ...), or -1 when done:
// the tiles are listed longest first, so a warp with a second tile takes a
// short one, and the two shortest go to the same warp.  (The f32 build deals
// its rounds of items the same way, over its own NW = NT_F32 / 32 warps.)
template <int NW = NWARP>
__device__ __forceinline__ int snake_tile(int warp, int turn, int count) {
  const int tile = turn * NW + (turn & 1 ? NW - 1 - warp : warp);
  return tile < count ? tile : -1;
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The loads read what other threads wrote before a barrier: "memory" keeps
// the compiler from moving them across it.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(shared_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(shared_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1]) : "r"(shared_addr(p)) : "memory");
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const bf16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1]) : "r"(shared_addr(p)) : "memory");
}
__device__ __forceinline__ void ldsm_x1(uint32_t& r, const bf16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x1.shared.b16 {%0}, [%1];"
               : "=r"(r) : "r"(shared_addr(p)) : "memory");
}

// d += a b: a 16 x 16 (row), b 16 x 8 (col), bf16; d f32
__device__ __forceinline__ void mma_k16(float (&d)[4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// d += a b: a 16 x 8, b 8 x 8
__device__ __forceinline__ void mma_k8(float (&d)[4], const uint32_t (&a)[2], uint32_t b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// acc[nt] += the products of k steps 0 .. ksteps-1 in that order, whose
// fragments load(a, b, ks) brings: step ks + 1 loads while step ks
// multiplies.  ksteps may be 0 (a rank without columns): the first load then
// reads zero pads and nothing is added.  (Odd steps summed into a second
// accumulator ran a step about 100 SM clocks faster, but that order left a
// phase-6 chain's scalars just outside chip_smoke.py's rule (ii): PERF.md.)
template <int NB, typename Load>
__device__ __forceinline__ void tile_pairs(float (&acc)[NB][4], Load load, int ksteps) {
  uint32_t a0[4], b0[NB][2], a1[4], b1[NB][2];
  load(a0, b0, 0);
  int ks = 0;
  for (; ks + 2 <= ksteps; ks += 2) {
    load(a1, b1, ks + 1);
#pragma unroll
    for (int nt = 0; nt < NB; ++nt) mma_k16(acc[nt], a0, b0[nt]);
    if (ks + 2 < ksteps) load(a0, b0, ks + 2);
#pragma unroll
    for (int nt = 0; nt < NB; ++nt) mma_k16(acc[nt], a1, b1[nt]);
  }
  if (ks < ksteps) {
#pragma unroll
    for (int nt = 0; nt < NB; ++nt) mma_k16(acc[nt], a0, b0[nt]);
  }
}

// The forward product of 16 own columns: acc[nt][..] += sum over k <
// 16 ksteps of W[k][j0 + m] * H[k][8 nt + n], for the NB n8 tiles of the
// rows.  W is a weight slice [k][ldw] (A = W^T: ldmatrix.trans), H the
// layer's rows of H16 [k][hp] (B: .trans).  The next k step's fragments load
// while this one's products run (tile_pairs).
template <int NB>
__device__ __forceinline__ void tile_forward(float (&acc)[NB][4], const bf16_t* W, int ldw,
                                             int j0, const bf16_t* H, int hp, int ksteps,
                                             int lane) {
  const int q = lane >> 3, rr = lane & 7;
  const bf16_t* wa = W + (rr + 8 * (q >> 1)) * ldw + j0 + 8 * (q & 1);
  const bf16_t* hb = H + (rr + 8 * (q & 1)) * hp;
  auto load = [&](uint32_t (&a)[4], uint32_t (&b)[NB][2], int ks) {
    ldsm_x4_trans(a, wa + ks * 16 * ldw);
#pragma unroll
    for (int nt = 0; nt < NB; ++nt) ldsm_x2_trans(b[nt], hb + ks * 16 * hp + nt * 8);
  };
  tile_pairs<NB>(acc, load, ksteps);
}

// The backward product of 16 latent columns: acc[nt][..] += sum over the
// own columns j < 16 ksteps of W[i0 + m][j] * E[j][8 nt + n].  W is a weight
// slice [i][ldw] (A: ldmatrix), E the own err or S of E16 [j][hp] (B:
// .trans).  The k steps load ahead, as tile_forward's.
template <int NB>
__device__ __forceinline__ void tile_backward(float (&acc)[NB][4], const bf16_t* W, int ldw,
                                              int i0, const bf16_t* E, int hp, int ksteps,
                                              int lane) {
  const int q = lane >> 3, rr = lane & 7;
  const bf16_t* wa = W + (i0 + rr + 8 * (q & 1)) * ldw + 8 * (q >> 1);
  const bf16_t* eb = E + (rr + 8 * (q & 1)) * hp;
  auto load = [&](uint32_t (&a)[4], uint32_t (&b)[NB][2], int ks) {
    ldsm_x4(a, wa + ks * 16);
#pragma unroll
    for (int nt = 0; nt < NB; ++nt) ldsm_x2_trans(b[nt], eb + ks * 16 * hp + nt * 8);
  };
  tile_pairs<NB>(acc, load, ksteps);
}

// The Hebbian products of 16 input features: their rows of H16 [k][hp]
// over the KR = rows_n8(R) row positions are the A fragments (ldmatrix),
// loaded once for all the own columns; 16 positions take a k16 step, a last
// 8 a k8 step.
template <int KR>
struct HebbianA {
  static constexpr int K16 = KR / 16;
  uint32_t k16[K16 > 0 ? K16 : 1][4];
  uint32_t k8[2];
  __device__ __forceinline__ void load(const bf16_t* H, int hp, int lane) {
    const int q = lane >> 3, rr = lane & 7;
    const bf16_t* ha = H + (rr + 8 * (q & 1)) * hp + 8 * (q >> 1);
#pragma unroll
    for (int s = 0; s < K16; ++s) ldsm_x4(k16[s], ha + 16 * s);
    if constexpr (KR % 16 != 0) ldsm_x2(k8, ha + KR - 8);
  }
};

// acc[..] += sum over the positions p of H[m][p] * (E[n][p] ^ flip), a 16 x 8
// gradient tile: A the features' fragments, E the 8 own columns' rows of
// E16 [j][hp] (B: ldmatrix; flip 0x80008000 negates both bf16 of a
// register).
template <int KR>
__device__ __forceinline__ void tile_hebbian(float (&acc)[4], const HebbianA<KR>& A,
                                             const bf16_t* E, int hp, uint32_t flip,
                                             int lane) {
  const bf16_t* eb = E + (lane & 7) * hp + 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int s = 0; s < HebbianA<KR>::K16; ++s) {
    uint32_t b[2];
    ldsm_x2(b, eb + 16 * s);
    b[0] ^= flip;
    b[1] ^= flip;
    mma_k16(acc, A.k16[s], b);
  }
  if constexpr (KR % 16 != 0) {
    uint32_t b;
    ldsm_x1(b, eb + KR - 8);
    mma_k8(acc, A.k8, b ^ flip);
  }
}

// The sensory loss of one logit l with target y, in double (bernoulli or
// gaussian): out of line, as few steps sum it and inlined per element of a
// tile its code filled most of the forward pass's instructions.
__device__ __noinline__ double loss_term(double l, double y, int loss, float inv_var) {
  return loss == 1 ? fmax(l, 0.0) - l * y + log1p(exp(-fabs(l)))
                   : 0.5 * (double)inv_var * (l - y) * (l - y);
}

constexpr int NOISE_SLOTS = 4; // own elements a thread draws noise for ahead
constexpr int NOISE_EARLY = 2; // of which drawn at the end of the step before

// -------------------------------------------------------------- kernel

// OPT: the instantiation that takes the options (captures, scalar slots,
// masks, Adam state, the output-PC site; see "Options" in the header);
// without it the kernel carries none of their code.  ACT: relu or tanh.
// BF16: the products take bf16 operands (see "bf16 products" in the header).
// NOISE: the packed or the unpacked noise indexing ("Noise indexing").
template <int RG, bool OPT, int ACT, bool BF16, int NOISE>
__global__ void __launch_bounds__(BF16 ? NT : NT_F32, 1) mcpc_chain_kernel(const ChainArgs a) {
  constexpr int NTB = BF16 ? NT : NT_F32;   // threads of this build's block
  constexpr int NWB = NTB / 32;
  using RW = Rows<RG>;
  constexpr int R = 2 * RG;    // rows a cluster; a job takes half of them
  constexpr int RP = RW::PITCH;
  constexpr int NB = rows_n8(R) / 8;   // BF16: n8 tiles of the rows
  constexpr bool WC = kWarpClocks && !BF16;   // per-warp clocks (profiling build)
  constexpr int CLOCK_ROW = N_PHASE + (WC ? WARP_CLOCKS * NWB : 0);
  extern __shared__ __align__(16) float smem[];
  __shared__ double red[2][NWB];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31;
  const int row0 = (int)(blockIdx.x / CS) * R;   // first row of this cluster
  const int nvalid = min(R, a.B - row0);         // its rows inside the batch

  const int d0 = a.d0, d1 = a.d1, d2 = a.d2, D = a.D;
  const int n = d0 + d1 + d2;        // packed latent width (unpadded)
  const int c1 = d0, c2 = d0 + d1;   // packed columns where x1 and x2 start
  const bool with_pg = a.partials != nullptr;
  const bool out_pc = OPT && a.x3 != nullptr;   // an output-PC site
  const Layout L = make_layout<BF16>(d0, d1, d2, D, R, a.warm_T > 0,
                                     with_pg ? (a.grads_resident ? 2 : 1) : 0, out_pc);
  float* H = smem + L.H;     // [n][RP] act(latents), all columns (not BF16)
  float* X = smem + L.X;     // [OWN][RP] own latent columns
  float* E = smem + L.E;     // [OWN][RP] their errors
  float* S = smem + L.S;     // [ND][RP] dLoss/dlogits of the own output columns
  float* P = smem + L.P;     // [CS][OWN][RP] the ranks' partial backward products
  float* M = smem + L.M;     // [OWN][RP] Adam moments (warm only)
  float* V = smem + L.V;
  float* W1 = smem + L.W1;   // [d0][LD1] W1[:, own x1 columns]
  float* W2 = smem + L.W2;   // [d1][LD2] W2[:, own x2 columns]
  float* W3 = smem + L.W3;   // [d2][LD3] W3[:, own output columns]
  float* BI = smem + L.BI;   // own b0 | b1 | b2 (at 0, J1, J2) | b3 (at OWN)
  float* GB = smem + L.GB;   // own bias gradients, laid out as BI
  int* OT = reinterpret_cast<int*>(smem + L.OT);   // [n] owner << 16 | own-column index
  float* X3 = smem + L.X3;   // [ND][RP] own columns of x3 (output-PC site)
  float* M3 = smem + L.M3;   // [ND][RP] their Adam moments (warm only)
  float* V3 = smem + L.V3;
  // BF16: the products' operands ("bf16 products" in the header), [..][HP]
  // by position, pads zero
  bf16_t* H16 = BF16 ? reinterpret_cast<bf16_t*>(smem + L.H) : nullptr;   // act(X):
                             // x0 at row 0, x1 at HB1, x2 at HB2
  bf16_t* E16 = BF16 ? reinterpret_cast<bf16_t*>(smem + L.E16) : nullptr;  // own err1 |
                             // err2 (at EB2) | S (at EBS)
  bf16_t* W16_1 = BF16 ? reinterpret_cast<bf16_t*>(smem + L.W1) : nullptr;  // [up16(d0)][LW1]
  bf16_t* W16_2 = BF16 ? reinterpret_cast<bf16_t*>(smem + L.W2) : nullptr;  // [up16(d1)][LW2]
  bf16_t* W16_3 = BF16 ? reinterpret_cast<bf16_t*>(smem + L.W3) : nullptr;  // [up16(d2)][LW3]

  // own slices: first column and width, per layer
  const int lo0 = a.lo[0][rank], n0 = a.lo[0][rank + 1] - lo0;
  const int lo1 = a.lo[1][rank], n1 = a.lo[1][rank + 1] - lo1;
  const int lo2 = a.lo[2][rank], n2 = a.lo[2][rank + 1] - lo2;
  const int loD = a.lo[3][rank], nD = a.lo[3][rank + 1] - loD;

  // dst[row][padded column] = src[own column][row] for the own columns and
  // valid rows; dst is an aligned [B, XW] array
  auto store_own = [&](float* dst, const float* src) {
    for (int e = tid; e < L.OWN * R; e += NTB) {
      const int r = e / L.OWN, j = e - r * L.OWN;
      const int row = row0 + r;
      if (row >= a.B) continue;
      int pc;
      if (j < L.J1) { if (j >= n0) continue; pc = lo0 + j; }
      else if (j < L.J2) { if (j - L.J1 >= n1) continue; pc = a.O1 + lo1 + j - L.J1; }
      else { if (j - L.J2 >= n2) continue; pc = a.O2 + lo2 + j - L.J2; }
      dst[(size_t)row * a.XW + pc] = src[j * RP + RW::pos(r)];
    }
  };
  // dst[row][loD + j] = src[j][row] for the own output columns and valid
  // rows; dst has rows of `ld` floats
  auto store_out = [&](float* dst, int ld, const float* src) {
    for (int e = tid; e < nD * R; e += NTB) {
      const int r = e / nD, j = e - r * nD;
      const int row = row0 + r;
      if (row < a.B) dst[(size_t)row * ld + loD + j] = src[j * RP + RW::pos(r)];
    }
  };

  // own gradient slices: in shared memory (laid out as the weights) or in
  // this cluster's partial in device memory
  PartialLayout pg = {};
  float* G1 = nullptr; float* G2 = nullptr; float* G3 = nullptr;
  int ldg1 = 0, ldg2 = 0, ldg3 = 0;
  if (with_pg) {
    pg = partial_layout(a.partials + (size_t)(blockIdx.x / CS) *
                                         partial_floats(d0, d1, d2, D),
                        d0, d1, d2, D);
    if (a.grads_resident) {
      G1 = smem + L.G1; ldg1 = L.LD1;
      G2 = smem + L.G2; ldg2 = L.LD2;
      G3 = smem + L.G3; ldg3 = L.LD3;
    } else {
      G1 = pg.gw1 + lo1; ldg1 = d1;
      G2 = pg.gw2 + lo2; ldg2 = d2;
      G3 = pg.gw3 + loD; ldg3 = D;
    }
  }

  // ---- prologue: state, weights and biases into shared memory
  if constexpr (BF16) {
    // the bf16 arrays, which come first, start at zero: their pads stay so
    for (size_t e = tid; e < L.X / 4; e += NTB)
      reinterpret_cast<uint4*>(smem)[e] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
  }
  for (int e = tid; e < R * n; e += NTB) {
    const int r = e / n, c = e - r * n;
    const int row = row0 + r;
    float x = 0.f;
    if (row < a.B) {
      if (c < c1) x = a.x0[(size_t)row * d0 + c];
      else if (c < c2) x = a.x1[(size_t)row * d1 + (c - c1)];
      else x = a.x2[(size_t)row * d2 + (c - c2)];
    }
    if constexpr (BF16) {   // x = 0 beyond the batch: H16 0 there
      const int hc = c + (c < c1 ? 0 : c < c2 ? L.HB1 - c1 : L.HB2 - c2);
      H16[hc * L.HP + RW::pos(r)] = __float2bfloat16_rn(activate<ACT>(x));
    } else {
      H[c * RP + RW::pos(r)] = activate<ACT>(x);
    }
    int j = -1;   // own column?
    if (c < c1) { if (c >= lo0 && c < lo0 + n0) j = c - lo0; }
    else if (c < c2) { if (c - c1 >= lo1 && c - c1 < lo1 + n1) j = L.J1 + c - c1 - lo1; }
    else if (c - c2 >= lo2 && c - c2 < lo2 + n2) j = L.J2 + c - c2 - lo2;
    if (j >= 0) {
      X[j * RP + RW::pos(r)] = x;
      if (a.warm_T > 0) {
        // a continuation resumes the moments of the caller's optimizer
        const bool resume = OPT && a.m_in != nullptr && row < a.B;
        const size_t at = (size_t)row * a.XW +
                          (c < c1 ? c : c < c2 ? a.O1 + c - c1 : a.O2 + c - c2);
        M[j * RP + RW::pos(r)] = resume ? a.m_in[at] : 0.f;
        V[j * RP + RW::pos(r)] = resume ? a.v_in[at] : 0.f;
      }
    }
  }
  auto load_slice = [&](float* dst, int ld, const float* w, int K, int N, int lo, int nk) {
    for (int e = tid; e < K * nk; e += NTB) {
      const int k = e / nk, c = e - k * nk;
      dst[k * ld + c] = w[(size_t)k * N + lo + c];
    }
  };
  if constexpr (BF16) {   // the wrapper rounded the weights: exact
    auto load_slice16 = [&](bf16_t* dst, int ld, const float* w, int K, int N, int lo,
                            int nk) {
      for (int e = tid; e < K * nk; e += NTB) {
        const int k = e / nk, c = e - k * nk;
        dst[k * ld + c] = __float2bfloat16_rn(w[(size_t)k * N + lo + c]);
      }
    };
    load_slice16(W16_1, L.LW1, a.w1, d0, d1, lo1, n1);
    load_slice16(W16_2, L.LW2, a.w2, d1, d2, lo2, n2);
    load_slice16(W16_3, L.LW3, a.w3, d2, D, loD, nD);
  } else {
    load_slice(W1, L.LD1, a.w1, d0, d1, lo1, n1);
    load_slice(W2, L.LD2, a.w2, d1, d2, lo2, n2);
    load_slice(W3, L.LD3, a.w3, d2, D, loD, nD);
  }
  for (int c = tid; c < n; c += NTB) {
    const int layer = c < c1 ? 0 : c < c2 ? 1 : 2;
    const int col = c < c1 ? c : c < c2 ? c - c1 : c - c2;
    int owner = 0;   // the rank whose slice holds col
    while (col >= a.lo[layer][owner + 1]) ++owner;
    OT[c] = owner << 16 |
            ((layer == 0 ? 0 : layer == 1 ? L.J1 : L.J2) + col - a.lo[layer][owner]);
  }
  if (out_pc) {   // the own columns of x3 and, warm, their moments
    for (int e = tid; e < R * nD; e += NTB) {
      const int r = e / nD, j = e - r * nD;
      const int row = row0 + r;
      const bool valid = row < a.B;
      X3[j * RP + RW::pos(r)] = valid ? a.x3[(size_t)row * D + loD + j] : 0.f;
      if (a.warm_T > 0) {
        const bool resume = a.m3_in != nullptr && valid;
        const size_t at = (size_t)row * a.pD + loD + j;
        M3[j * RP + RW::pos(r)] = resume ? a.m3_in[at] : 0.f;
        V3[j * RP + RW::pos(r)] = resume ? a.v3_in[at] : 0.f;
      }
    }
  }
  for (int c = tid; c < n0; c += NTB) BI[c] = a.b0[lo0 + c];
  for (int c = tid; c < n1; c += NTB) BI[L.J1 + c] = a.b1[lo1 + c];
  for (int c = tid; c < n2; c += NTB) BI[L.J2 + c] = a.b2[lo2 + c];
  for (int c = tid; c < nD; c += NTB) BI[L.OWN + c] = a.b3[loD + c];
  if (with_pg) {
    for (int e = tid; e < L.OWN + L.ND; e += NTB) GB[e] = 0.f;
    auto zero_slice = [&](float* g, int ldg, int K, int nk) {
      for (int e = tid; e < K * nk; e += NTB) {
        const int k = e / nk, c = e - k * nk;
        g[(size_t)k * ldg + c] = 0.f;
      }
    };
    zero_slice(G1, ldg1, d0, n1);
    zero_slice(G2, ldg2, d1, n2);
    zero_slice(G3, ldg3, d2, nD);
  }
  // f32: the hand-offs' barriers ("Design" in the header).  P_bar takes an
  // arrival from every rank and the bytes of the partials they push into
  // this block's P; H_bar this block's own arrival and the bytes of act(x)
  // the owners push into its H: n * R floats
  const uint32_t p_bar = shared_addr(smem), h_bar = p_bar + 8u;   // f32: L.MB = 0
  if constexpr (!BF16) {
    if (tid == 0) {
      mbar_init(p_bar, CS);
      mbar_init(h_bar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }
  // every block of the cluster is running, its barriers set, before a peer
  // writes into it
  cluster.sync();

  long long spent[N_PHASE] = {0, 0, 0, 0, 0, 0};
  long long last = clock64();
  auto lap = [&](int phase) {
    if (a.clocks != nullptr && tid == 0) {
      const long long now = clock64();
      spent[phase] += now - last;
      last = now;
    }
  };
  long long wclk[WARP_CLOCKS] = {0, 0, 0}, w_step = 0;   // WC only

  const bool has_s = a.loss != 0 || out_pc;
  const int total = a.warm_T + a.T;
  float b1p = a.b1p0, b2p = a.b2p0;   // Adam bias-correction powers
  double loss_acc = 0.0, en_acc = 0.0;
  // the threads' sums by shuffle within each warp, into red[][warp]
  auto block_sums = [&](double l, double en) {
    for (int off = 16; off > 0; off >>= 1) {
      l += __shfl_down_sync(0xffffffffu, l, off);
      en += __shfl_down_sync(0xffffffffu, en, off);
    }
    if (lane == 0) {
      red[0][tid >> 5] = l;
      red[1][tid >> 5] = en;
    }
  };

  const int nS = has_s ? nD : 0;
  // The f32 products ("products" above): the forward's quads of 4
  // neighbouring own columns of S (K = d2), err2 (K = d1) and err1 (K = d0),
  // the long sums first; the backward's quads of the x2 columns (a sum over
  // the own output columns), x1 (over the own x2 columns) and x0 (over the
  // own x1 columns), a quad's 4 columns NQ apart
  const int fq0 = (nS + 3) / 4, fq1 = (n2 + 3) / 4, fq2 = (n1 + 3) / 4;
  const int bq0 = has_s ? (d2 + 3) / 4 : 0, bq1 = (d1 + 3) / 4, bq2 = (d0 + 3) / 4;
  // gradient jobs: a quad of 4 neighbouring own columns and PG_ROWS rows of
  // gW3, gW2, gW1
  const int h1 = fq0 * ((d2 + PG_ROWS - 1) / PG_ROWS);
  const int h2 = h1 + fq1 * ((d1 + PG_ROWS - 1) / PG_ROWS);
  const int h3 = h2 + fq2 * ((d0 + PG_ROWS - 1) / PG_ROWS);

  // the own element (column j of X, position r within it) of update slot p,
  // or j = -1
  auto own_element = [&](int p, int& j, int& r, int& layer, int& col) {
    const int e = tid + p * NTB;
    j = -1;
    if (e >= L.OWN * R) return;
    const int jj = e / R;
    r = e - jj * R;
    if (jj < L.J1) { layer = 0; col = jj; if (col >= n0) return; col += lo0; }
    else if (jj < L.J2) { layer = 1; col = jj - L.J1; if (col >= n1) return; col += lo1; }
    else { layer = 2; col = jj - L.J2; if (col >= n2) return; col += lo2; }
    j = jj;
  };
  const uint32_t dp = out_pc ? 4u : 2u;   // draws a step pair
  // the normal of Langevin step t at position r of the own column `col`
  // (the layer's global column) of latent `layer`
  auto noise = [&](int t, int r, int layer, int col) {
    const int row = row0 + RW::row_at(r);
    if constexpr (NOISE == NOISE_UNPACKED) {
      // _normals over [B, half]: r*cos in the first half of the columns,
      // r*sin in the rest, at the same grid element
      const int half = ((layer == 0 ? d0 : layer == 1 ? d1 : d2) + 1) >> 1;
      const bool take_sin = col >= half;
      return box_muller((uint32_t)a.seed, 6u * (uint32_t)t + 2u * (uint32_t)layer,
                        (uint32_t)row * (uint32_t)half + (uint32_t)(take_sin ? col - half : col),
                        take_sin);
    } else {
      const uint32_t pc = (uint32_t)((layer == 0 ? 0 : layer == 1 ? a.O1 : a.O2) + col);
      return langevin_normal((uint32_t)a.seed + (uint32_t)(row / a.tile_B), t,
                             (uint32_t)(row % a.tile_B) * (uint32_t)a.XW + pc, dp);
    }
  };
  const int slots = (L.OWN * R + NTB - 1) / NTB;
  // The noise of a step touches registers only, so it is drawn while the
  // hand-offs complete: slots [0, NOISE_EARLY) before the wait that ends the
  // step before, the rest before the one in the step.
  float z[NOISE_SLOTS] = {0.f, 0.f, 0.f, 0.f};
  auto draw = [&](int t, int p) {
    int j, r, layer, col;
    own_element(p, j, r, layer, col);
    return j >= 0 ? noise(t, r, layer, col) : 0.f;
  };
  if (a.noise_std > 0.f && a.warm_T == 0 && a.T > 0) {
#pragma unroll
    for (int p = 0; p < NOISE_EARLY; ++p) z[p] = draw(0, p);
  }

  for (int s = 0; s < total; ++s) {
    if constexpr (WC) w_step = clock64();
    const bool warm = s < a.warm_T;
    const int t = s - a.warm_T;
    // the step's index in the phase that captures and emits slots: the
    // Langevin phase, or the warm phase of a warm-only chain
    const int cs = a.T > 0 ? t : s;
    const bool last = s == total - 1;
    const bool slot_step = OPT && a.slots != nullptr && cs >= 0 && cs % a.scal_stride == 0;
    const bool sums_now = slot_step || (a.want_scalars && last);
    const float cw1 = 1.0f - b1p, cw2 = 1.0f - b2p;

    // ---- capture: the pre-update latents of the own columns
    if constexpr (OPT) {
      if (a.traj != nullptr && cs >= 0 && cs % a.cap_stride == 0) {
        store_own(a.traj + (size_t)(cs / a.cap_stride) * a.B * a.XW, X);
        if (out_pc) store_out(a.traj3 + (size_t)(cs / a.cap_stride) * a.B * a.pD, a.pD, X3);
      }
    }

    // ---- forward: the own columns' errors and S, from H and the own weights
    if constexpr (BF16) {
      // a warp a tile of 16 own columns and all the rows: S first (K = d2),
      // then err2 (K = d1), then err1 (K = d0)
      const int mS = (nS + 15) / 16, m2 = mS + (n2 + 15) / 16, m1 = m2 + (n1 + 15) / 16;
      for (int turn = 0, item; (item = snake_tile(tid >> 5, turn, m1)) >= 0; ++turn) {
        const bf16_t* W; const bf16_t* Hl; bf16_t* E16l;
        int ldw, j0, ncols, K, jbase;
        if (item < mS) {
          W = W16_3; ldw = L.LW3; Hl = H16 + L.HB2 * L.HP; E16l = E16 + L.EBS * L.HP;
          j0 = 16 * item; ncols = nS; K = d2; jbase = -1;
        } else if (item < m2) {
          W = W16_2; ldw = L.LW2; Hl = H16 + L.HB1 * L.HP; E16l = E16 + L.EB2 * L.HP;
          j0 = 16 * (item - mS); ncols = n2; K = d1; jbase = L.J2;
        } else {
          W = W16_1; ldw = L.LW1; Hl = H16; E16l = E16;
          j0 = 16 * (item - m2); ncols = n1; K = d0; jbase = L.J1;
        }
        // the target (x3 at an output-PC site) of the tile's elements, loaded
        // before the products so that their latency hides behind them
        float acc[NB][4], yv[NB][4];
#pragma unroll
        for (int nt = 0; nt < NB; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[nt][i] = 0.f;
            const int col = j0 + (lane >> 2) + 8 * (i >> 1);
            const int p = 8 * nt + 2 * (lane & 3) + (i & 1);
            const int row = row0 + RW::row_at(p < R ? p : 0);
            yv[nt][i] = jbase >= 0 || col >= ncols || p >= R ? 0.f
                        : out_pc ? X3[col * RP + p]
                        : row < a.B ? __ldg(a.y + (size_t)row * D + loD + col) : 0.f;
          }
        tile_forward<NB>(acc, W, ldw, j0, Hl, L.HP, up16(K) / 16, lane);
        // The epilogue computes every element of the tile, its indices
        // clamped into the arrays, and stores the real ones: straight-line
        // code whose sigmoids and loads overlap (a branch an element left
        // them one after another, several thousand clocks a step).
        float out[NB][4];
        auto each = [&](auto f) {   // out = f(product, target, column, position)
#pragma unroll
          for (int nt = 0; nt < NB; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              out[nt][i] = f(acc[nt][i], yv[nt][i],
                             min(j0 + (lane >> 2) + 8 * (i >> 1), ncols - 1),
                             min(8 * nt + 2 * (lane & 3) + (i & 1), R - 1));
        };
        if (jbase >= 0) {
          each([&](float v, float, int col, int p) {
            return X[(jbase + col) * RP + p] - (v + BI[jbase + col]);
          });
        } else if (a.loss == 1) {   // masked columns (OPT) are not clamped: 0
          each([&](float v, float y, int col, int) {
            const float lg = v + BI[L.OWN + col];
            return !OPT || loD + col >= a.mask_lo ? (0.5f + 0.5f * tanhf(0.5f * lg)) - y : 0.f;
          });
        } else {
          each([&](float v, float y, int col, int) {
            const float lg = v + BI[L.OWN + col];
            return !OPT || loD + col >= a.mask_lo ? (lg - y) * a.inv_var : 0.f;
          });
        }
#pragma unroll
        for (int nt = 0; nt < NB; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int col = j0 + (lane >> 2) + 8 * (i >> 1);
            const int p = 8 * nt + 2 * (lane & 3) + (i & 1);   // a position
            if (col >= ncols || p >= R) continue;
            const bool valid = row0 + RW::row_at(p) < a.B;
            if (jbase >= 0) E[(jbase + col) * RP + p] = out[nt][i];
            else S[col * RP + p] = out[nt][i];
            // the operand of the backward and Hebbian products: 0 beyond the batch
            E16l[col * L.HP + p] = __float2bfloat16_rn(valid ? out[nt][i] : 0.f);
            if (!sums_now || !valid) continue;
            if (jbase >= 0) {
              en_acc += (double)out[nt][i] * out[nt][i];
            } else if (!OPT || loD + col >= a.mask_lo) {
              const double l = acc[nt][i] + BI[L.OWN + col], yd = yv[nt][i];
              if (out_pc)   // the site's energy; the 0.5 comes with the layers'
                en_acc += (double)a.inv_var * (l - yd) * (l - yd);
              else
                loss_acc += loss_term(l, yd, a.loss, a.inv_var);
            }
          }
      }
    } else {  // f32: FMAs on the CUDA cores, rounds of items in snake order
      const Deal fwd(2 * fq0, d2, 2 * fq1, d1, 2 * fq2, d0);   // a quad's two halves of the rows
      long long w_first = 0;
      if constexpr (WC) w_first = clock64();
      for (int turn = 0, rnd; (rnd = snake_tile<NWB>(tid >> 5, turn, fwd.rounds)) >= 0; ++turn) {
        const int part = lane / QUADS;
        int i;
        const int c = fwd.cls(rnd * QUADS + (lane & (QUADS - 1)), i);
        const float* A = H; const float* W = W1;
        int K = 0, ld = L.LD1, ncols = 0, jbase = L.J1;
        if (c == 0) { A = H + c2 * RP; W = W3; K = d2; ld = L.LD3; ncols = nS; jbase = -1; }
        else if (c == 1) { A = H + c1 * RP; W = W2; K = d1; ld = L.LD2; ncols = n2; jbase = L.J2; }
        else if (c == 2) { K = d0; ncols = n1; }
        const int q = i >> 1, g = i & 1, rg = g * RG;   // a quad of columns, a half of the rows
        const int col = 4 * q + part;   // this lane's column after the reduce
        const bool mine = col < ncols;  // (no item: ncols 0)
        // the quad's 4 weights of row k, side by side in the slice (its pad
        // columns are never stored)
        const float* wq = W + 4 * q;
        auto load_w = [&](int k, float (&w)[4]) {
          const float4 x = reinterpret_cast<const float4*>(wq + k * ld)[0];
          w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
        };
        float yv[RG];   // the target, or x3 at an output-PC site
        if (out_pc && mine && jbase < 0) {
          load_rows<RG>(yv, X3 + col * RP, g);
        } else {
#pragma unroll
          for (int r = 0; r < RG; ++r) {
            const int row = row0 + rg + r;
            yv[r] = mine && jbase < 0 && row < a.B ? __ldg(a.y + (size_t)row * D + loD + col) : 0.f;
          }
        }
        float acc[4][RG];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int r = 0; r < RG; ++r) acc[u][r] = 0.f;
        quad_dot<RG, true>(acc, [&](int k, float (&av)[RG]) {
          load_rows<RG>(av, A + k * RP, g);
        }, load_w, part, K);
        float out[RG];
        quad_reduce<RG>(out, acc, lane);
        if (!mine) continue;
        if (jbase < 0) {
          const float bj = BI[L.OWN + col];
          const bool clamped = !OPT || loD + col >= a.mask_lo;
#pragma unroll
          for (int r = 0; r < RG; ++r) {
            const float lg = out[r] + bj;
            out[r] = !clamped ? 0.f
                     : a.loss == 1 ? (0.5f + 0.5f * tanhf(0.5f * lg)) - yv[r]
                                   : (lg - yv[r]) * a.inv_var;
            if (sums_now && clamped && row0 + rg + r < a.B) {
              const double l = lg, yd = yv[r];
              if (out_pc)   // the site's energy; the 0.5 comes with the layers'
                en_acc += (double)a.inv_var * (l - yd) * (l - yd);
              else
                loss_acc += a.loss == 1
                    ? fmax(l, 0.0) - l * yd + log1p(exp(-fabs(l)))
                    : 0.5 * (double)a.inv_var * (l - yd) * (l - yd);
            }
          }
          store_rows<RG>(S + col * RP, g, out);
        } else {
          const int j = jbase + col;
          const float bj = BI[j];
          float xv[RG];
          load_rows<RG>(xv, X + j * RP, g);
#pragma unroll
          for (int r = 0; r < RG; ++r) {
            out[r] = xv[r] - (out[r] + bj);
            if (sums_now && row0 + rg + r < a.B) en_acc += (double)out[r] * out[r];
          }
          store_rows<RG>(E + j * RP, g, out);
        }
      }
      if constexpr (WC) {
        const long long now = clock64();
        wclk[0] += w_first - w_step;
        wclk[1] += now - w_first;
      }
    }
    for (int e = tid; e < n0 * R; e += NTB) {   // err0 = x0 - b0
      const int j = e / R, r = e - j * R;
      const float er = X[j * RP + r] - BI[j];
      E[j * RP + r] = er;
      if (sums_now && row0 + RW::row_at(r) < a.B) en_acc += (double)er * er;
    }
    if (OPT && sums_now) {   // the step's sums: warps by shuffle, then over warps
      block_sums(loss_acc, en_acc);
      loss_acc = en_acc = 0.0;
    }
    __syncthreads();
    if (OPT && sums_now && tid == 0) {
      // red is written again only on a later step, behind the step's
      // barriers (f32: its two __syncthreads after this one)
      double l = 0.0, en = 0.0;
      for (int w = 0; w < NWB; ++w) {
        l += red[0][w];
        en += red[1][w];
      }
      en *= 0.5;
      if (a.slots != nullptr) {
        double* mine = a.slots + (size_t)blockIdx.x * a.n_slots * 2;
        if (slot_step) {
          mine[2 * (cs / a.scal_stride)] = l;
          mine[2 * (cs / a.scal_stride) + 1] = en;
        }
        if (last) {
          mine[2 * (a.n_slots - 1)] = l;
          mine[2 * (a.n_slots - 1) + 1] = en;
        }
      } else {
        a.scal[2 * blockIdx.x] = l;
        a.scal[2 * blockIdx.x + 1] = en;
      }
    }
    lap(0);

    // ---- sampling step: Hebbian gradients of the own columns from H, E and
    // S of the state before the update.  Nothing writes H, E or S before
    // the step's first hand-off (bf16: cluster barrier), so no barrier is
    // needed after it.
    if (with_pg && (warm ? (a.pg_warm && s == a.warm_T - 1) : t >= a.mixing)) {
      if constexpr (BF16) {
        // a warp the 16 x (own columns) tile of 16 input features of gW3,
        // gW2 or gW1, 8 columns at a time; K = the row positions; C is the
        // running sum in the slice
        const int a3 = (d2 + 15) / 16, a2 = a3 + (d1 + 15) / 16, a1 = a2 + (d0 + 15) / 16;
        for (int turn = 0, item; (item = snake_tile(tid >> 5, turn, a1)) >= 0; ++turn) {
          const bf16_t* Hl; const bf16_t* E16l; float* gw;
          size_t gs;   // where the resident slice starts in shared memory
          int K, nk, ldg, k0; uint32_t flip;   // flip: -err, as the f32 code's sign
          if (item < a3) {
            Hl = H16 + L.HB2 * L.HP; E16l = E16 + L.EBS * L.HP; gw = G3; gs = L.G3;
            K = d2; nk = nS; ldg = ldg3; k0 = 16 * item; flip = 0u;
          } else if (item < a2) {
            Hl = H16 + L.HB1 * L.HP; E16l = E16 + L.EB2 * L.HP; gw = G2; gs = L.G2;
            K = d1; nk = n2; ldg = ldg2; k0 = 16 * (item - a3); flip = 0x80008000u;
          } else {
            Hl = H16; E16l = E16; gw = G1; gs = L.G1;
            K = d0; nk = n1; ldg = ldg1; k0 = 16 * (item - a2); flip = 0x80008000u;
          }
          HebbianA<rows_n8(R)> A;
          A.load(Hl + k0 * L.HP, L.HP, lane);
          // the running sums of 8 columns from j0 on: each tile loads the
          // next one's before its own products, so their latency (device
          // memory where the slice is not resident) overlaps
          float next[4];
          auto sums_of = [&](int j0, float (&c)[4]) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int k = k0 + (lane >> 2) + 8 * (i >> 1), j = j0 + 2 * (lane & 3) + (i & 1);
              const size_t at = (size_t)k * ldg + j;
              c[i] = !(k < K && j < nk) ? 0.f : a.grads_resident ? smem[gs + at] : gw[at];
            }
          };
          sums_of(0, next);
          for (int j0 = 0; j0 < nk; j0 += 8) {
            float acc[4] = {next[0], next[1], next[2], next[3]};
            if (j0 + 8 < nk) sums_of(j0 + 8, next);
            tile_hebbian<rows_n8(R)>(acc, A, E16l + j0 * L.HP, L.HP, flip, lane);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int k = k0 + (lane >> 2) + 8 * (i >> 1), j = j0 + 2 * (lane & 3) + (i & 1);
              const size_t at = (size_t)k * ldg + j;
              if (!(k < K && j < nk)) continue;
              if (a.grads_resident) smem[gs + at] = acc[i];
              else gw[at] = acc[i];
            }
          }
        }
      } else  // f32: FMAs on the CUDA cores
      for (int job = tid; job < h3; job += NTB) {
        const float* A; const float* Vc; float* gw;
        int K, nk, NQ, ldg, jb; float sign;
        size_t gs;   // where the resident slice starts in shared memory
        if (job < h1) {
          A = H + c2 * RP; Vc = S; gw = G3; gs = L.G3; K = d2; nk = nS; NQ = fq0; ldg = ldg3;
          jb = job; sign = 1.f;
        } else if (job < h2) {
          A = H + c1 * RP; Vc = E + L.J2 * RP; gw = G2; gs = L.G2; K = d1; nk = n2;
          NQ = fq1; ldg = ldg2; jb = job - h1; sign = -1.f;
        } else {
          A = H; Vc = E + L.J1 * RP; gw = G1; gs = L.G1; K = d0; nk = n1; NQ = fq2;
          ldg = ldg1; jb = job - h2; sign = -1.f;
        }
        const int chunk = jb / NQ, q = jb - chunk * NQ;
        float v[4][R];   // by position; rows beyond the batch and columns beyond the slice 0
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int col = 4 * q + u;
          load_positions<R>(v[u], Vc + min(col, nk - 1) * RP);
#pragma unroll
          for (int r = 0; r < R; ++r)
            v[u][r] = col < nk && RW::row_at(r) < nvalid ? sign * v[u][r] : 0.f;
        }
        // gw[k][4q + u] += dot[u]: the resident slice (pitch 8 * odd) as one
        // float4 of shared memory; in device memory column by column
        auto add = [&](int k, const float (&dot)[4]) {
          const size_t at = (size_t)k * ldg + 4 * q;
          if (a.grads_resident) {
            float4* g4 = reinterpret_cast<float4*>(smem + gs + at);
            float4 x = *g4;
            x.x += dot[0]; x.y += dot[1]; x.z += dot[2]; x.w += dot[3];
            *g4 = x;
          } else {
#pragma unroll
            for (int u = 0; u < 4; ++u)
              if (4 * q + u < nk) gw[at + u] += dot[u];
          }
        };
        const int k1 = min(K, (chunk + 1) * PG_ROWS);
        for (int k = chunk * PG_ROWS; k < k1; ++k) {
          float h[R];
          load_positions<R>(h, A + k * RP);
          float dot[4] = {0.f, 0.f, 0.f, 0.f};   // four sums side by side, each in a fixed order
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int u = 0; u < 4; ++u) dot[u] = fmaf(h[r], v[u][r], dot[u]);
          add(k, dot);
        }
      }
      // bias gradients: -err of the own latent columns, +S of the own outputs
      for (int j = tid; j < L.OWN + nS; j += NTB) {
        const float* src = j < L.OWN ? E + j * RP : S + (j - L.OWN) * RP;
        const float sign = j < L.OWN ? -1.f : 1.f;
        float sum = 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r) sum += RW::row_at(r) < nvalid ? sign * src[r] : 0.f;
        GB[j] += sum;
      }
      lap(1);
    }

    // ---- backward: for every latent column, the partial product over the
    // own out-columns, written into the owner's P at this block's rank
    if constexpr (BF16) {
      // a warp a tile of 16 latent columns and all the rows: the x2 columns
      // (K = the own output columns), then x1 (K = the own x2 columns), then
      // x0 (K = the own x1 columns)
      const int mb2 = has_s ? (d2 + 15) / 16 : 0, mb1 = mb2 + (d1 + 15) / 16;
      const int mb0 = mb1 + (d0 + 15) / 16;
      for (int turn = 0, item; (item = snake_tile(tid >> 5, turn, mb0)) >= 0; ++turn) {
        const bf16_t* W; const bf16_t* E16l;
        int ldw, i0, ncols, K, cbase;
        if (item < mb2) {
          W = W16_3; ldw = L.LW3; E16l = E16 + L.EBS * L.HP;
          i0 = 16 * item; ncols = d2; K = nD; cbase = c2;
        } else if (item < mb1) {
          W = W16_2; ldw = L.LW2; E16l = E16 + L.EB2 * L.HP;
          i0 = 16 * (item - mb2); ncols = d1; K = n2; cbase = c1;
        } else {
          W = W16_1; ldw = L.LW1; E16l = E16;
          i0 = 16 * (item - mb1); ncols = d0; K = n1; cbase = 0;
        }
        float acc[NB][4];
#pragma unroll
        for (int nt = 0; nt < NB; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
        tile_backward<NB>(acc, W, ldw, i0, E16l, L.HP, (K + 15) / 16, lane);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = i0 + (lane >> 2) + 8 * h;
          if (i >= ncols) continue;
          const int home = OT[cbase + i];   // owner << 16 | its own-column index
          float* dst = cluster.map_shared_rank(P, home >> 16) +
                       ((size_t)rank * L.OWN + (home & 0xffff)) * RP;
#pragma unroll
          for (int nt = 0; nt < NB; ++nt) {
            const int p = 8 * nt + 2 * (lane & 3);   // R is even: p + 1 < R too
            if (p < R)
              *reinterpret_cast<float2*>(dst + p) = make_float2(acc[nt][2 * h],
                                                                acc[nt][2 * h + 1]);
          }
        }
      }
    } else {  // f32: FMAs on the CUDA cores, rounds of items in snake order
      const Deal bwd(bq0, nD, bq1, n2, bq2, n1);
      long long w_first = 0;
      if constexpr (WC) w_first = clock64();
      for (int turn = 0, rnd; (rnd = snake_tile<NWB>(tid >> 5, turn, bwd.rounds)) >= 0; ++turn) {
        const int part = lane / QUADS;
        int q;   // the item's quad
        const int c = bwd.cls(rnd * QUADS + (lane & (QUADS - 1)), q);
        const float* A = E + L.J1 * RP; const float* W = W1;
        int K = 0, ld = L.LD1, ncols = 1, NQ = 1, cbase = 0;
        if (c == 0) { A = S; W = W3; K = nD; ld = L.LD3; ncols = d2; NQ = bq0; cbase = c2; }
        else if (c == 1) { A = E + L.J2 * RP; W = W2; K = n2; ld = L.LD2; ncols = d1; NQ = bq1; cbase = c1; }
        else if (c == 2) { K = n1; ncols = d0; NQ = bq2; }
        int off[4];   // the quad's 4 rows of the weight slice
#pragma unroll
        for (int u = 0; u < 4; ++u) off[u] = min(q + u * NQ, ncols - 1) * ld;
        float acc[4][R];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int p = 0; p < R; ++p) acc[u][p] = 0.f;
        quad_dot<R, false>(acc, [&](int k, float (&av)[R]) {
          load_positions<R>(av, A + k * RP);
        }, [&](int k, float (&w)[4]) {
#pragma unroll
          for (int u = 0; u < 4; ++u) w[u] = W[off[u] + k];
        }, part, K);
        float out[R];
        quad_reduce<R>(out, acc, lane);
        const int i = q + part * NQ;   // this lane's column after the reduce
        if (c < 0 || i >= ncols) continue;
        const int home = OT[cbase + i];   // owner << 16 | its own-column index
        const uint32_t at = shared_addr(P + ((size_t)rank * L.OWN + (home & 0xffff)) * RP);
        push_positions<R>(peer_addr(at, home >> 16), out, peer_addr(p_bar, home >> 16));
      }
      if constexpr (WC) wclk[2] += clock64() - w_first;
    }
    lap(2);
    if constexpr (BF16) {
      cluster_arrive();
    } else {
      // this block's own arrivals, which arm this step's phases with the
      // bytes they expect; then, every warp's partials pushed and its reads
      // of H done, one arrival on each peer's P_bar, releasing the block's
      // reads and writes to the cluster
      if (tid == 0) {   // the x2 columns' partials only where there is an S
        mbar_arrive_expect(p_bar, (uint32_t)(CS * (n0 + n1 + (has_s ? n2 : 0)) * R * 4));
        mbar_arrive_expect(h_bar, (uint32_t)(n * R * 4));
      }
      __syncthreads();
      if (tid < CS && tid != rank) mbar_arrive_remote(peer_addr(p_bar, tid));
    }
    const bool noisy = !warm && a.noise_std > 0.f;
    if (noisy) {
#pragma unroll
      for (int p = NOISE_EARLY; p < NOISE_SLOTS; ++p) z[p] = draw(t, p);
    }
    if (out_pc) {
      // the own columns of x3 take their step, with the gradient
      // inv_var3 (x3 - logits) = -S of this step (nothing else reads X3, M3,
      // V3 or this block's S until the next step)
      for (int e = tid; e < nD * R; e += NTB) {
        const int j = e / R, r = e - j * R;
        const float g3 = -S[j * RP + r];
        float x = X3[j * RP + r];
        if (warm) {
          const float m = a.wb1 * M3[j * RP + r] + a.one_m_b1 * g3;
          const float v = a.wb2 * V3[j * RP + r] + a.one_m_b2 * g3 * g3;
          M3[j * RP + r] = m;
          V3[j * RP + r] = v;
          x = x - a.warm_lr * (m / cw1) / (sqrtf(v / cw2) + a.weps);
        } else {
          x = x - a.lr * g3;
          if (noisy) {
            const int row = row0 + RW::row_at(r);
            x = x + a.noise_std * langevin_normal(
                (uint32_t)a.seed + (uint32_t)(row / a.tile_B), t,
                (uint32_t)(row % a.tile_B) * (uint32_t)a.pD + (uint32_t)(loD + j), 4u, 2u);
          }
        }
        X3[j * RP + r] = x;
      }
    }
    if constexpr (BF16) cluster_wait();
    else mbar_wait(p_bar, (uint32_t)s & 1u);   // every rank's partials are in P
    lap(3);

    // ---- the own latent columns: add the partials in rank order, update,
    // and write the new act(x) into every block's H
    auto update = [&](int p, float zp, bool have_z) {
      int j, r, layer, col;
      own_element(p, j, r, layer, col);
      if (j < 0) return;
      float back = 0.f;
      if (layer < 2 || has_s) {
        back = P[j * RP + r];
#pragma unroll
        for (int k = 1; k < CS; ++k) back += P[((size_t)k * L.OWN + j) * RP + r];
        if (layer == 2) back = -back;    // back2 = -(S W3^T)
      }
      float x = X[j * RP + r];
      float dh;   // act'(x)
      if constexpr (ACT == ACT_TANH && BF16) {
        // the H this block holds is rounded: tanh(x) again, from x
        const float h = tanhf(x);
        dh = 1.f - h * h;
      } else if constexpr (ACT == ACT_TANH) {
        // tanh(x) as this block holds it, not yet overwritten
        const float h = H[((layer == 0 ? 0 : layer == 1 ? c1 : c2) + col) * RP + r];
        dh = 1.f - h * h;
      } else {
        dh = x > 0.f ? 1.f : 0.f;
      }
      const float g = E[j * RP + r] - dh * back;
      if (warm) {
        const float m = a.wb1 * M[j * RP + r] + a.one_m_b1 * g;
        const float v = a.wb2 * V[j * RP + r] + a.one_m_b2 * g * g;
        M[j * RP + r] = m;
        V[j * RP + r] = v;
        x = x - a.warm_lr * (m / cw1) / (sqrtf(v / cw2) + a.weps);
      } else {
        x = x - a.lr * g;
        if (noisy) x = x + a.noise_std * (have_z ? zp : noise(t, r, layer, col));
      }
      X[j * RP + r] = x;
      if constexpr (BF16) {   // 0 beyond the batch, where the Hebbian sums read it
        const bf16_t h = __float2bfloat16_rn(RW::row_at(r) < nvalid ? activate<ACT>(x) : 0.f);
        const int c = (layer == 0 ? 0 : layer == 1 ? L.HB1 : L.HB2) + col;
#pragma unroll
        for (int k = 0; k < CS; ++k) cluster.map_shared_rank(H16, k)[c * L.HP + r] = h;
      } else {
        const float h = activate<ACT>(x);
        const int c = (layer == 0 ? 0 : layer == 1 ? c1 : c2) + col;
        const uint32_t at = shared_addr(H + c * RP + r);
#pragma unroll
        for (int k = 0; k < CS; ++k) push(peer_addr(at, k), h, peer_addr(h_bar, k));
      }
    };
#pragma unroll
    for (int p = 0; p < NOISE_SLOTS; ++p) update(p, z[p], true);
    for (int p = NOISE_SLOTS; p < slots; ++p) update(p, 0.f, false);
    lap(4);
    // bf16: also the last barrier before exit: no peer touches this block's
    // shared memory after it
    if constexpr (BF16) cluster_arrive();
    if (a.noise_std > 0.f && s + 1 >= a.warm_T && s + 1 < total) {
#pragma unroll
      for (int p = 0; p < NOISE_EARLY; ++p) z[p] = draw(t + 1, p);
    }
    if constexpr (BF16) {
      cluster_wait();
    } else {
      __syncthreads();   // the block's update and x3 step done
      mbar_wait(h_bar, (uint32_t)s & 1u);   // every owner's act(x) is in H
    }
    lap(5);
    if (warm) {
      b1p *= a.wb1;
      b2p *= a.wb2;
    }
  }

  // f32: no peer touches this block's shared memory after this barrier
  if constexpr (!BF16) {
    cluster_arrive();
    cluster_wait();
  }

  // ---- epilogue: own latent columns, gradient slice, scalars
  for (int e = tid; e < L.OWN * R; e += NTB) {
    const int r = e / L.OWN, j = e - r * L.OWN;
    const int row = row0 + r;
    if (row >= a.B) continue;
    const float x = X[j * RP + RW::pos(r)];
    if (j < L.J1) { if (j < n0) a.o0[(size_t)row * d0 + lo0 + j] = x; }
    else if (j < L.J2) { if (j - L.J1 < n1) a.o1[(size_t)row * d1 + lo1 + j - L.J1] = x; }
    else if (j - L.J2 < n2) a.o2[(size_t)row * d2 + lo2 + j - L.J2] = x;
  }
  if (with_pg) {
    if (a.grads_resident) {
      auto store_slice = [&](float* dst, int N, int lo, const float* g, int ld, int K, int nk) {
        for (int e = tid; e < K * nk; e += NTB) {
          const int k = e / nk, c = e - k * nk;
          dst[(size_t)k * N + lo + c] = g[k * ld + c];
        }
      };
      store_slice(pg.gw1, d1, lo1, G1, L.LD1, d0, n1);
      store_slice(pg.gw2, d2, lo2, G2, L.LD2, d1, n2);
      store_slice(pg.gw3, D, loD, G3, L.LD3, d2, nD);
    }
    for (int c = tid; c < n0; c += NTB) pg.gb0[lo0 + c] = GB[c];
    for (int c = tid; c < n1; c += NTB) pg.gb1[lo1 + c] = GB[L.J1 + c];
    for (int c = tid; c < n2; c += NTB) pg.gb2[lo2 + c] = GB[L.J2 + c];
    for (int c = tid; c < nD; c += NTB) pg.gb3[loD + c] = GB[L.OWN + c];
  }

  if (!OPT && a.want_scalars) {   // the last step's sums, as the loop left them
    block_sums(loss_acc, en_acc);
    __syncthreads();
    if (tid == 0) {
      double l = 0.0, en = 0.0;
      for (int w = 0; w < NWB; ++w) {
        l += red[0][w];
        en += red[1][w];
      }
      a.scal[2 * blockIdx.x] = l;
      a.scal[2 * blockIdx.x + 1] = 0.5 * en;
    }
  }

  if (OPT && a.m_out != nullptr) {   // the Adam moments after the warm phase
    store_own(a.m_out, M);
    store_own(a.v_out, V);
    if (out_pc) {
      store_out(a.m3_out, a.pD, M3);
      store_out(a.v3_out, a.pD, V3);
    }
  }
  if (out_pc) store_out(a.o3, D, X3);

  if (a.clocks != nullptr && tid == 0) {
#pragma unroll
    for (int i = 0; i < N_PHASE; ++i) a.clocks[(size_t)blockIdx.x * CLOCK_ROW + i] = spent[i];
  }
  if constexpr (WC) {
    if (a.clocks != nullptr && lane == 0) {
#pragma unroll
      for (int i = 0; i < WARP_CLOCKS; ++i)
        a.clocks[(size_t)blockIdx.x * CLOCK_ROW + N_PHASE + (tid >> 5) * WARP_CLOCKS + i] =
            wclk[i];
    }
  }
}

// ------------------------------------------------------------ launches

inline void cluster_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                           int clusters, size_t smem, cudaStream_t stream) {
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3((unsigned)(clusters * CS));
  cfg.blockDim = dim3(kBF16 ? NT : NT_F32);   // this build's block
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CS;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
}

// this build's kernel (f32 products, or bf16 ones with -DMCPC_BF16) for a
// call of `a.B` rows
template <int RG, bool OPT, int ACT, int NOISE>
cudaError_t launch_kernel(const ChainArgs& a, size_t smem, cudaStream_t stream) {
  constexpr int R = 2 * RG;
  cudaError_t err = cudaFuncSetAttribute(
      mcpc_chain_kernel<RG, OPT, ACT, kBF16, NOISE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(cfg, attr, (a.B + R - 1) / R, smem, stream);
  err = cudaLaunchKernelEx(&cfg, mcpc_chain_kernel<RG, OPT, ACT, kBF16, NOISE>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// clusters of the relu kernel without options the device can run at once,
// or -cudaError_t (the packed library's other instantiations take the same
// shared memory and no more registers than one block an SM allows: 255 a
// thread at NT threads, 128 at NT_F32)
template <int RG, int NOISE>
int max_clusters(size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      mcpc_chain_kernel<RG, false, ACT_RELU, kBF16, NOISE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(cfg, attr, 1, smem, nullptr);
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(
      &count, mcpc_chain_kernel<RG, false, ACT_RELU, kBF16, NOISE>, &cfg);
  return err != cudaSuccess ? -(int)err : count;
}

// dynamic shared memory a block may use on `device` (the opt-in maximum less
// the kernel's static shared memory, which does not depend on the rows), or -1
template <int NOISE>
int smem_budget(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, mcpc_chain_kernel<1, false, ACT_RELU, kBF16, NOISE>) !=
      cudaSuccess)
    return -1;
  return optin - (int)attr.sharedSizeBytes;
}

// Copies the plan's slices, 4 x (CS + 1) ints (for x0, x1, x2 and the
// output, the first column of every rank's slice and, last, the layer's
// width), into a.lo; false unless they cut each layer in order into parts
// of at most widest_slice columns.
inline bool set_slices(ChainArgs& a, const int* slices) {
  const int widths[4] = {a.d0, a.d1, a.d2, a.D};
  for (int l = 0; l < 4; ++l) {
    const int* lo = slices + l * (CS + 1);
    if (lo[0] != 0 || lo[CS] != widths[l]) return false;
    for (int k = 0; k < CS; ++k)
      if (lo[k + 1] < lo[k] || lo[k + 1] - lo[k] > widest_slice(widths[l])) return false;
    for (int k = 0; k <= CS; ++k) a.lo[l][k] = lo[k];
  }
  return true;
}

inline int pad128(int d) { return (d + 127) / 128 * 128; }

}  // namespace mcpc
