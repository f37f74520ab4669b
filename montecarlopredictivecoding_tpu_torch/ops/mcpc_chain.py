"""Fused whole-chain MCPC: the Hopper kernels' wrapper, their plain PyTorch
version, and the counter-hash noise all of them use.

``mcpc_chain`` runs (optionally) ``warm_T`` Adam MAP steps on the latents,
then ``T`` Langevin steps, and (optionally) accumulates the Hebbian
parameter gradients over the sampling steps, over the canonical generative
MLP (``act`` is relu or tanh)

    zeros -> Linear(d0,d0) -> PC(x0) -> act -> Linear(d0,d1) -> PC(x1)
          -> act -> Linear(d1,d2) -> PC(x2) -> act -> Linear(d2,D) -> loss

with the closed-form energy gradient

    err0 = x0 - b0;  err_l = x_l - (act(x_{l-1}) W_l + b_l)
    S    = sigmoid(logits) - y | (logits - y)/input_var | 0
    G    = [err0 | err1 | err2] - act'(x) * [err1 W1ᵀ | err2 W2ᵀ | -S W3ᵀ]

(``act' = 1 - tanh(x)²`` for tanh) and, on a sampling step, from the state
before the update,

    gW1 += -act(x0)ᵀ err1   gW2 += -act(x1)ᵀ err2   gW3 += act(x2)ᵀ S
    gb0 += Σ -err0   gb1 += Σ -err1   gb2 += Σ -err2   gb3 += Σ S

With ``output_var`` the model ends in a trailing PC site (the JAX package's
output-PC joint sampler): the sensory layer is a fourth latent ``x3`` with
energy ``0.5/output_var·|x3 - logits|²`` and no loss, so ``S = (logits -
x3)/output_var`` and ``x3`` takes the same Adam or Langevin steps with the
gradient ``-S``.

Options, as the JAX wrapper's: captures of the pre-update latents every
``capture_stride`` steps, per-step scalar slots every ``scalar_stride``
steps, masked sensory losses (``mask_perc``), the Adam state of the warm
phase handed out (``emit_warm_opt_state``) or resumed (``warm_mu``,
``warm_nu``, ``warm_count``), and bf16 products (``bf16_matmul``).

bf16.  With ``bf16_matmul`` every matrix product takes bf16 operands
(round-to-nearest-even) and sums in f32; everything else stays f32:
latents, biases, errors, ``S``, the Adam state, the gradient sums, the
noise.  The rounded operands are the JAX kernels': the weights (once, per
call), ``act(x)`` in the forward products, ``[err1 | err2 | -S]`` in the
backward ones, and both factors of the Hebbian products.  ``act'`` and the
bias gradients use the unrounded values, and so do the captured steps'
recomputed scalars (as the JAX wrapper's, in full f32 from the f32
weights).  A product of two bf16 values is exact in f32, so the kernels'
bf16 build, whose products run on the tensor cores (``mma`` with f32
accumulators), differs from the plain version only in the order of the
sums.  The f32 build's products are FMAs on the CUDA cores.
:func:`tf32_split` and :func:`tf32_split_matmul` are split-TF32 arithmetic
(each f32 operand as two TF32 halves, a product as three) in plain PyTorch:
a tensor-core route for f32 products was measured and not kept
(``PERF.md``), and they serve the diagnosis of such a route
(``scripts/chain_c_draws.py``).

On CUDA tensors it launches a hand-written kernel: ``csrc/mcpc_chain.cu``,
which replaces the JAX package's Pallas kernel
``ops/pallas_mcpc.py::_make_packed_kernel``, or with ``packed=False``
``csrc/mcpc_chain_unpacked.cu``, which replaces ``_make_kernel``.  Both
instantiate one cluster kernel (``csrc/mcpc_cluster.cuh``) and differ only
in the noise indexing: one thread-block cluster per group of batch rows,
with every layer's weights split by output column over the cluster's blocks
and kept in shared memory; :func:`chain_plan` decides the split for both.
With parameter gradients every cluster leaves a partial sum, and
:func:`sum_block_partials` (a second kernel) adds them in order.  On CPU
tensors it runs :func:`mcpc_chain_reference`, the same arithmetic in plain
PyTorch.  There is no fallback from one to the other.

Noise.  Both versions draw the Langevin noise from the stateless counter
hash of the JAX package's interpret mode (``_fmix32``, ``_mock_bits``,
``_uniforms``, ``_sincos_2pi``), with its indexing: the seed of a batch tile
is ``seed + tile_i``, an element's index is ``local_row * XW + padded_col``
over the 128-padded packed layout of :func:`aligned_layout`, and Langevin
step pair ``p`` reads draws ``2p`` and ``2p+1`` (step ``2p`` takes ``r·cos``,
step ``2p+1`` ``r·sin``); with an output-PC site the latents read ``4p`` and
``4p+1`` and ``x3`` reads ``4p+2`` and ``4p+3`` at ``local_row * pD + col``
(``pD`` = D padded to 128).  So the port's chain equals
``mcpc_chain_pallas(..., interpret=True)`` element by element, up to f32
rounding.  Nothing is stored padded: the padding enters only the index.
The unpacked chain has its own indexing (:func:`_unpacked_normals`,
:func:`unpacked_noise_site`).

The hash is 32-bit unsigned arithmetic.  ``torch.uint32`` lacks the needed
ops, so the PyTorch version keeps the values in int64 and reduces mod 2**32,
splitting each multiplication so no intermediate exceeds 2**49.
"""

from __future__ import annotations

import contextlib
import ctypes
import ctypes.util
import dataclasses
import functools
import math
import typing as tp

import numpy as np
import torch

from ..core.model import PCModel
from ..core.modules import PC, Activation, activation_fn, gaussian_energy
from ..utils.observability import span
from ..utils.precision import full_f32_matmul

Tensor = torch.Tensor

_SUPPORTED_ACTS = ("relu", "tanh")
_ACT_CODES = {"relu": 0, "tanh": 1}
_M32 = 0xFFFFFFFF

_CANONICAL_KINDS = [
    "Linear", "PC", "Activation", "Linear", "PC", "Activation",
    "Linear", "PC", "Activation", "Linear",
]


def model_activation(model: PCModel) -> tp.Optional[str]:
    """The model's uniform activation name if the kernel supports it, else
    None."""
    names = {m.name for m in model.modules if isinstance(m, Activation)}
    if len(names) == 1:
        name = names.pop()
        if name in _SUPPORTED_ACTS:
            return name
    return None


def supports_model(model: PCModel, activation: tp.Optional[str] = None) -> bool:
    """The kernel covers the canonical 4-Linear MLP with 3 PC sites, a
    uniform supported activation, the default Gaussian energy and no S/M
    masks.  Pass ``activation`` to require a specific one."""
    kinds = [type(m).__name__ for m in model.modules]
    if kinds != _CANONICAL_KINDS:
        return False
    act = model_activation(model)
    if act is None or (activation is not None and act != activation):
        return False
    # the closed-form gradients assume 0.5*(mu-x)^2 everywhere
    return all(
        m.energy_fn is gaussian_energy and m.S is None and m.M is None
        for m in model.modules
        if isinstance(m, PC)
    )


def output_pc_var(model: PCModel) -> tp.Optional[float]:
    """The trailing PC site's Gaussian variance when ``model`` is the
    canonical MLP plus a trailing PC site (the output-PC joint sampler of
    figure 3: ``make_mlp_model(..., output_pc=PC(energy_fn=
    scaled_gaussian_energy(var)))``), else None.  The trailing energy must be
    a (scaled) Gaussian with no S/M masks, the hidden sites as
    :func:`supports_model` asks."""
    kinds = [type(m).__name__ for m in model.modules]
    if kinds != _CANONICAL_KINDS + ["PC"] or model_activation(model) is None:
        return None
    pcs = model.pc_layers
    if not all(m.energy_fn is gaussian_energy and m.S is None and m.M is None
               for m in pcs[:-1]):
        return None
    var = getattr(pcs[-1].energy_fn, "gaussian_var", None)
    if var is None or pcs[-1].S is not None or pcs[-1].M is not None:
        return None
    return float(var)


def _pad128(d: int) -> int:
    return -(-d // 128) * 128


def aligned_layout(dims: tp.Sequence[int]):
    """128-aligned packed layout for latent dims: (padded widths, block
    offsets, total width).  Every block starts at a multiple of 128."""
    pads = tuple(_pad128(d) for d in dims)
    offs, o = [], 0
    for p in pads:
        offs.append(o)
        o += p
    return pads, tuple(offs), o


def _pick_batch_tile(B: int, cap: int = 1024) -> int:
    """Largest divisor of B that is at most ``cap`` (the JAX kernel's batch
    tile; here it only keys the noise)."""
    if B <= cap:
        return B
    for t in range(cap, 0, -1):
        if B % t == 0:
            return t
    return B


# ---------------------------------------------------------------- noise


def _mul32(x, c: int):
    """``x * c mod 2**32`` for ``0 <= x < 2**32`` held in int64, without
    overflow: the constant is split into 16-bit halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _fmix32(x):
    """murmur3 finalizer on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def counter_bits_at(idx: Tensor, seed, draw) -> Tensor:
    """Draw ``draw`` of the stream keyed ``seed`` at element indices ``idx``
    (int64): two murmur3-finalizer rounds over a Weyl-style combination.
    ``seed`` and ``draw`` are ints or int64 tensors that broadcast against
    ``idx``; both are taken mod 2**32.  Returns uint32 values in int64."""
    h = (_mul32(seed & _M32, 0x9E3779B1) + _mul32(draw & _M32, 0x6C62272E)) & _M32
    return _fmix32(_fmix32((h + idx) & _M32) ^ 0xA511E9B3)


def counter_bits(shape, seed, draw, device="cuda") -> Tensor:
    """The uint32 grid (in int64) of ``_mock_bits(shape, seed, draw)``: the
    element index is ``row * cols + col``."""
    rows, cols = shape
    idx = torch.arange(rows * cols, dtype=torch.int64, device=device)
    return counter_bits_at(idx.reshape(rows, cols), seed, draw)


def _unit_from_bits(bits: Tensor) -> Tensor:
    """``(bits >> 9) | 0x3F800000`` read as float32: a value in [1, 2)."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)


def uniforms(bits1: Tensor, bits2: Tensor) -> tp.Tuple[Tensor, Tensor]:
    """(u1, u2) by exponent bitcast: u1 = 2 - f1 in (0, 1] (safe for log),
    u2 = f2 - 1 in [0, 1)."""
    return 2.0 - _unit_from_bits(bits1), _unit_from_bits(bits2) - 1.0


def sincos_2pi(u: Tensor) -> tp.Tuple[Tensor, Tensor]:
    """``(cos(2*pi*u), sin(2*pi*u))`` for ``u`` in [0, 1) via quadrant
    reduction and odd/even Taylor polynomials on [0, pi/2); max abs error
    about 5e-7."""
    t = 4.0 * u
    q = torch.floor(t)
    x = (math.pi / 2.0) * (t - q)  # [0, pi/2)
    x2 = x * x
    s = x * (1.0 + x2 * (-1.66666667e-1 + x2 * (8.33333333e-3
             + x2 * (-1.98412698e-4 + x2 * (2.75573192e-6
             + x2 * (-2.50521084e-8))))))
    c = 1.0 + x2 * (-0.5 + x2 * (4.16666667e-2
             + x2 * (-1.38888889e-3 + x2 * (2.48015873e-5
             + x2 * (-2.75573192e-7 + x2 * 2.08767570e-9)))))
    qi = q.to(torch.int32) & 3
    swap = (qi & 1) == 1
    s1 = torch.where(swap, c, s)
    c1 = torch.where(swap, s, c)
    return (
        torch.where((qi == 1) | (qi == 2), -c1, c1),
        torch.where(qi >= 2, -s1, s1),
    )


def box_muller(bits1: Tensor, bits2: Tensor) -> tp.Tuple[Tensor, Tensor]:
    """Both Box-Muller normals ``(r·cos, r·sin)`` from two bit grids."""
    u1, u2 = uniforms(bits1, bits2)
    r = torch.sqrt(-2.0 * torch.log(u1))
    c, s = sincos_2pi(u2)
    return r * c, r * s


# ------------------------------------------------------------- options

_LOSS_CODES = {"none": 0, "bernoulli": 1, "gaussian": 2}


@dataclasses.dataclass(frozen=True)
class _Chain:
    """Validated arguments of one chain call."""

    dims: tp.Tuple[int, int, int, int]
    T: int
    lr: float
    noise_std: float
    loss: str            # "bernoulli", "gaussian" or "none"; a mask is mask_lo
    inv_var: float
    warm_T: int
    warm_lr: float
    warm_b1: float
    warm_b2: float
    warm_eps: float
    return_scalars: bool
    tile: int
    seed: int
    mixing: int
    with_pgrads: bool
    warm_pgrads: bool
    packed: bool
    # output columns below mask_lo are not clamped (0: all are)
    mask_lo: int = 0
    capture_stride: int = 0
    n_cap: int = 0
    scalar_stride: int = 0
    n_slots: int = 0
    emit_opt_state: bool = False
    # Adam bias powers of the first warm step: (b1, b2), or b^(count+1) when
    # resuming an optimizer that has taken ``count`` steps
    bias0: tp.Tuple[float, float] = (0.9, 0.999)
    activation: str = "relu"
    # 1 / the output-PC site's variance, or None without the site
    inv_var3: tp.Optional[float] = None
    # the products take bf16 operands and sum in f32
    bf16_matmul: bool = False

    @property
    def output_pc(self) -> bool:
        return self.inv_var3 is not None


@functools.lru_cache(maxsize=None)
def _powf():
    """C's ``powf``, which ``jnp.power`` calls on a float32 scalar on the
    CPU: numpy's and torch's float32 powers round differently."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.powf.restype = ctypes.c_float
    libm.powf.argtypes = [ctypes.c_float, ctypes.c_float]
    return libm.powf


def bias_powers(b1: float, b2: float, count: int) -> tp.Tuple[float, float]:
    """``(b1^(count+1), b2^(count+1))`` in float32: the bias-correction powers
    of the first warm step of a chain that resumes an Adam state of ``count``
    steps (the JAX wrapper's ``bias0``)."""
    powf = _powf()
    n = float(np.float32(count + 1))
    tiny = float(np.finfo(np.float32).tiny)

    def power(b):  # subnormal results flush to zero, as XLA's do
        p = powf(float(np.float32(b)), n)
        return p if abs(p) >= tiny else 0.0

    return power(b1), power(b2)


def scalar_slots(T: int, warm_T: int, scalar_stride: int) -> int:
    """Slots of the per-step scalar mode: one per emitted step (t % stride
    == 0 over the Langevin phase, or over the warm phase of a warm-only
    chain) plus the final step's; 0 when the mode is off."""
    if scalar_stride <= 0:
        return 0
    steps = T if T > 0 else warm_T
    return -(-steps // scalar_stride) + 1


def _chain_args(params, latents, target, seed, *, T: int, lr: float,
                noise_var: tp.Optional[float] = 2.0, loss: str = "bernoulli",
                input_var: float = 1.0,
                mixing: int = 0,  # with_pgrads sums over steps t >= mixing
                with_pgrads: bool = False, packed: bool = True,
                warm_T: int = 0, warm_lr: float = 0.1, warm_b1: float = 0.9,
                warm_b2: float = 0.999, warm_eps: float = 1e-8,
                capture_stride: int = 0,
                activation: str = "relu", warm_pgrads: bool = False,
                return_scalars: bool = False,
                batch_tile: tp.Optional[int] = None,
                emit_warm_opt_state: bool = False,
                mask_perc: tp.Optional[float] = None,
                scalar_stride: int = 0,
                warm_mu=None, warm_nu=None, warm_count=None,
                output_var: tp.Optional[float] = None,
                bf16_matmul: bool = False,
                **unknown) -> _Chain:
    # what the JAX wrapper refuses, in its order and its words
    output_pc = output_var is not None
    if output_pc:
        if len(latents) != 4:
            raise ValueError("output_var requires 4 latents (trailing PC)")
        if loss != "none":
            raise ValueError(
                "output_var models are unclamped joint samplers (loss='none')"
            )
        if not packed:
            raise ValueError("output_var requires packed=True")
    n_sites = 4 if output_pc else 3
    if warm_T and not packed:
        raise ValueError("the Adam warm-start phase requires packed=True")
    if warm_pgrads and not warm_T:
        raise ValueError("warm_pgrads requires warm_T > 0")
    if emit_warm_opt_state and not warm_T:
        raise ValueError("emit_warm_opt_state requires warm_T > 0")
    warm_init = warm_mu is not None
    if warm_init:
        if not warm_T:
            raise ValueError("warm_mu/warm_nu require warm_T > 0")
        if warm_nu is None or warm_count is None:
            raise ValueError("warm_mu requires warm_nu and warm_count")
        if len(warm_mu) != n_sites or len(warm_nu) != n_sites:
            raise ValueError(
                f"warm moments must cover all {n_sites} latent sites"
            )
    if activation != "relu" and not packed:
        raise ValueError("packed=False supports relu only")
    if capture_stride > 0 and T == 0 and warm_T == 0:
        raise ValueError("capture_stride requires steps (T > 0 or warm_T > 0)")
    if scalar_stride > 0:
        if not packed or not return_scalars:
            raise ValueError(
                "scalar_stride requires packed=True and return_scalars"
            )
        if capture_stride > 0:
            raise ValueError(
                "scalar_stride and capture_stride are mutually exclusive: "
                "capture runs get per-step scalars recomputed from the "
                "trajectory"
            )
        if T == 0 and warm_T == 0:
            raise ValueError("scalar_stride requires steps (T or warm_T)")
    masked = loss.endswith("_mask")
    if masked:
        if mask_perc is None:
            raise ValueError("masked losses require mask_perc")
        if not packed:
            raise ValueError("masked losses require packed=True")
    if warm_pgrads and not with_pgrads:
        # the JAX kernel has no accumulators to add to without with_pgrads
        raise ValueError("warm_pgrads requires with_pgrads")
    if not packed:
        if return_scalars or batch_tile is not None:
            raise ValueError(
                "return_scalars/warm_pgrads/batch_tile require packed=True"
            )
        if capture_stride > 0:
            # the JAX wrapper returns no trajectory here without a word
            raise ValueError("capture_stride requires packed=True")
    if unknown:
        raise TypeError(f"mcpc_chain got an unexpected keyword {next(iter(unknown))!r}")
    base = loss[: -len("_mask")] if masked else loss
    if base not in _LOSS_CODES or (masked and base == "none"):
        raise ValueError(f"unknown loss {loss!r}")
    if activation not in _SUPPORTED_ACTS:
        raise ValueError(f"unsupported activation {activation!r}")
    if len(params) != 4 or len(latents) != n_sites:
        raise ValueError(
            f"mcpc_chain needs 4 Linear params and {n_sites} latents")
    x0, x1, x2 = latents[:3]
    B = x0.shape[0]
    w3 = params[3]["w"]
    dims = (x0.shape[1], x1.shape[1], x2.shape[1], w3.shape[1])
    expect = {
        1: (dims[0], dims[1]), 2: (dims[1], dims[2]), 3: (dims[2], dims[3]),
    }
    for i, shape in expect.items():
        if tuple(params[i]["w"].shape) != shape:
            raise ValueError(
                f"params[{i}]['w'] is {tuple(params[i]['w'].shape)}, "
                f"expected {shape}"
            )
    if B < 1 or any(x.shape[0] != B for x in latents):
        raise ValueError("latents must share one batch size of at least 1")
    if target is not None and tuple(target.shape) != (B, dims[3]):
        raise ValueError(f"target must be [{B}, {dims[3]}]")
    if output_pc and tuple(latents[3].shape) != (B, dims[3]):
        raise ValueError(f"the output-PC latent must be [{B}, {dims[3]}]")
    if T < 0 or warm_T < 0:
        raise ValueError("T and warm_T must be >= 0")
    if warm_init:
        for moments in (warm_mu, warm_nu):
            if [tuple(m.shape) for m in moments] != [tuple(x.shape) for x in latents]:
                raise ValueError("warm moments must be shaped like the latents")

    if not packed:
        tile = B  # one tile, the seed unshifted
    else:
        tile = _pick_batch_tile(B) if batch_tile is None else int(batch_tile)
    if B % tile != 0:
        raise ValueError(f"batch {B} not divisible by batch_tile {tile}")
    if packed and batch_tile is None and B > tile and tile < 128:
        raise ValueError(
            f"batch {B} has no tile divisor >= 128 (best: {tile}); pad the "
            "batch to a multiple of 128 or pass batch_tile explicitly"
        )
    # Python's round, as the JAX wrapper: a perc that rounds to 0 clamps all
    mask_k = round(dims[3] * mask_perc) if masked else 0
    cap_steps = T if T > 0 else warm_T
    seed = int(seed)
    return _Chain(
        dims=dims, T=int(T), lr=float(lr),
        # the JAX wrapper takes this square root in double
        noise_std=float(np.sqrt(lr * noise_var)) if noise_var else 0.0,
        loss=base, inv_var=1.0 / input_var, warm_T=int(warm_T),
        warm_lr=float(warm_lr), warm_b1=float(warm_b1),
        warm_b2=float(warm_b2), warm_eps=float(warm_eps),
        return_scalars=bool(return_scalars), tile=tile,
        # the JAX wrapper passes the seed as int32
        seed=((seed + 2**31) % 2**32) - 2**31,
        mixing=int(mixing), with_pgrads=bool(with_pgrads),
        warm_pgrads=bool(warm_pgrads), packed=bool(packed),
        mask_lo=max(dims[3] - mask_k, 0) if mask_k > 0 else 0,
        capture_stride=int(capture_stride) if capture_stride > 0 else 0,
        n_cap=-(-cap_steps // capture_stride) if capture_stride > 0 else 0,
        scalar_stride=int(scalar_stride) if scalar_stride > 0 else 0,
        n_slots=scalar_slots(T, warm_T, scalar_stride),
        emit_opt_state=bool(emit_warm_opt_state),
        bias0=(bias_powers(warm_b1, warm_b2, int(warm_count)) if warm_init
               else (float(np.float32(warm_b1)), float(np.float32(warm_b2)))),
        activation=activation,
        inv_var3=(1.0 / output_var) if output_pc else None,
        bf16_matmul=bool(bf16_matmul),
    )


def _result(c: _Chain, latents, pgrads, traj, traj3, scalars, moments):
    """The JAX wrapper's return order: ``latents, pgrads[, traj[, traj3]][,
    scalars][, (m, v[, m3, v3])]``."""
    out = [latents, pgrads]
    if c.capture_stride:
        out.append(traj)
        if c.output_pc:
            out.append(traj3)
    if c.return_scalars:
        out.append(scalars)
    if c.emit_opt_state:
        out.append(moments)
    return tuple(out)


def _pack_aligned(parts, dims) -> Tensor:
    """Per-latent ``[B, d_l]`` tensors placed in one aligned ``[B, XW]``
    tensor, pad lanes zero (the JAX package's packed latent layout)."""
    _, offs, XW = aligned_layout(dims)
    out = parts[0].new_zeros((parts[0].shape[0], XW))
    for part, o, d in zip(parts, offs, dims):
        out[:, o : o + d] = part
    return out


# The per-captured-step scalars are recomputed from the trajectory in chunks
# of this many rows, as the JAX wrapper does, so the forward's intermediates
# stay near 200 MB at 20-128-128-784 whatever the chain's length.
_SCALAR_RECOMPUTE_ROWS = 16384


def traj_scalar_rows(traj: Tensor, params, target, c: _Chain,
                     traj3: tp.Optional[Tensor] = None):
    """Pre-update ``(loss [n_cap], energy [n_cap])`` sums of every captured
    step, recomputed from the aligned trajectory ``[n_cap, B, XW]`` (and,
    with an output-PC site, ``traj3 [n_cap, B, pD]``; the JAX wrapper's
    ``_traj_scalar_rows``), in chunks of ``_SCALAR_RECOMPUTE_ROWS`` rows."""
    n_cap, B = traj.shape[0], traj.shape[1]
    chunk = max(1, _SCALAR_RECOMPUTE_ROWS // B)
    with span("mcpc.capture_rows"):
        parts = [_traj_scalar_block(traj[i : i + chunk], params, target, c,
                                    None if traj3 is None else traj3[i : i + chunk])
                 for i in range(0, n_cap, chunk)]
        return (torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]))


def _traj_scalar_block(traj: Tensor, params, target, c: _Chain, traj3=None):
    d0, d1, d2, D = c.dims
    _, offs, _ = aligned_layout((d0, d1, d2))
    b0 = params[0]["b"]
    (w1, b1), (w2, b2), (w3, b3) = ((params[i]["w"], params[i]["b"])
                                    for i in (1, 2, 3))
    x0 = traj[:, :, offs[0] : offs[0] + d0]
    x1 = traj[:, :, offs[1] : offs[1] + d1]
    x2 = traj[:, :, offs[2] : offs[2] + d2]
    act = activation_fn(c.activation)
    with full_f32_matmul():
        err0 = x0 - b0
        err1 = x1 - (torch.matmul(act(x0), w1) + b1)
        err2 = x2 - (torch.matmul(act(x1), w2) + b2)
        logits = torch.matmul(act(x2), w3) + b3
    energy = 0.5 * (torch.sum(err0 * err0, dim=(1, 2))
                    + torch.sum(err1 * err1, dim=(1, 2))
                    + torch.sum(err2 * err2, dim=(1, 2)))
    if traj3 is not None:
        err3 = traj3[:, :, :D] - logits
        energy = energy + 0.5 * c.inv_var3 * torch.sum(err3 * err3, dim=(1, 2))
    if c.loss == "none":
        return torch.zeros_like(energy), energy
    y = (target if target is not None else torch.zeros_like(logits[0]))[None]
    if c.loss == "bernoulli":
        elem = (torch.clamp(logits, min=0.0) - logits * y
                + torch.log1p(torch.exp(-torch.abs(logits))))
    else:
        elem = 0.5 * c.inv_var * (logits - y) ** 2
    if c.mask_lo:
        elem = elem[:, :, c.mask_lo:]
    return torch.sum(elem, dim=(1, 2)), energy


def _partial_sizes(dims) -> tp.Tuple[int, ...]:
    """Lengths of the blocks of one flat gradient vector, in the kernels'
    order: gW1, gW2, gW3, gb0, gb1, gb2, gb3."""
    d0, d1, d2, D = dims
    return (d0 * d1, d1 * d2, d2 * D, d0, d1, d2, D)


def _pgrads_from_flat(flat: Tensor, params, dims):
    """The params-shaped tuple of gradient dicts from one flat vector (views
    of it); ``pgrads[0]["w"]`` is zeros, its input being zeros."""
    d0, d1, d2, D = dims
    gw1, gw2, gw3, gb0, gb1, gb2, gb3 = flat.split(_partial_sizes(dims))
    return (
        {"w": torch.zeros_like(params[0]["w"]), "b": gb0},
        {"w": gw1.view(d0, d1), "b": gb1},
        {"w": gw2.view(d1, d2), "b": gb2},
        {"w": gw3.view(d2, D), "b": gb3},
    )


# ------------------------------------------------------- plain version


def _noise_index(c: _Chain, B: int, device) -> tp.Tuple[Tensor, Tensor]:
    """(element index [B, n], seed of the row's batch tile [B, 1]) over the
    unpadded packed columns, with the JAX kernel's 128-padded indexing."""
    d0, d1, d2, _ = c.dims
    _, offs, XW = aligned_layout((d0, d1, d2))
    cols = torch.cat([
        torch.arange(d, dtype=torch.int64, device=device) + o
        for d, o in zip((d0, d1, d2), offs)
    ])
    rows = torch.arange(B, dtype=torch.int64, device=device)
    idx = (rows % c.tile)[:, None] * XW + cols[None, :]
    seeds = (c.seed + rows // c.tile)[:, None]
    return idx, seeds


def _noise_index3(c: _Chain, B: int, device) -> Tensor:
    """The output-PC latent's element index [B, D]: ``local_row * pD + col``
    over the JAX kernel's ``[tile_B, pD]`` tile."""
    D = c.dims[3]
    rows = torch.arange(B, dtype=torch.int64, device=device)
    cols = torch.arange(D, dtype=torch.int64, device=device)
    return (rows % c.tile)[:, None] * _pad128(D) + cols[None, :]


@functools.lru_cache(maxsize=16)
def _unpacked_grid(dims3, B: int, device) -> tp.Tuple[Tensor, Tensor, Tensor]:
    """The three latents' ``[B, half]`` grids side by side: (element index
    [B, H], each column's draw offset ``2l`` [H], the columns of ``cat([r·cos,
    r·sin])`` that make ``[B, d0+d1+d2]``), ``H`` the sum of the halves."""
    halves = [(d + 1) // 2 for d in dims3]
    H = sum(halves)
    rows = torch.arange(B, dtype=torch.int64, device=device)
    idx = torch.cat([rows[:, None] * h + torch.arange(h, dtype=torch.int64, device=device)
                     for h in halves], dim=1)
    offset = torch.cat([torch.full((h,), 2 * l, dtype=torch.int64, device=device)
                        for l, h in enumerate(halves)])
    cols, first = [], 0
    for d, h in zip(dims3, halves):
        cols += (list(range(first, first + h)) + list(range(H + first, H + first + h)))[:d]
        first += h
    return idx, offset, torch.tensor(cols, dtype=torch.int64, device=device)


def _unpacked_normals(c: _Chain, B: int, t: int, device) -> Tensor:
    """Step ``t``'s normals ``[B, d0+d1+d2]`` of the unpacked baseline: per
    latent the JAX package's ``_normals`` over a ``[B, half]`` grid
    (``half = (d+1)//2``, ``r·cos`` in the first ``half`` columns, ``r·sin``
    in the rest), draws ``6t+{0,1}``, ``6t+{2,3}``, ``6t+{4,5}``.  The three
    grids are drawn side by side, both draws of a pair in one call: every
    element takes the same integer and float operations as alone."""
    idx, offset, cols = _unpacked_grid(tuple(c.dims[:3]), B, torch.device(device))
    draws = (6 * t + offset)[None, None, :] + torch.arange(
        2, dtype=torch.int64, device=idx.device)[:, None, None]
    bits = counter_bits_at(idx[None], c.seed, draws)
    zc, zs = box_muller(bits[0], bits[1])
    return torch.cat([zc, zs], dim=1).index_select(1, cols)


def unpacked_noise_site(dims, row: int, layer: int, col: int) -> tp.Tuple[int, int, bool]:
    """Where the unpacked chain's normal of ``(row, col)`` of latent ``layer``
    comes from, as the kernel computes it (``csrc/mcpc_cluster.cuh``, the
    ``noise`` lambda): ``(draw_offset, idx, take_sin)``.  Step ``t`` reads
    draws ``6t + draw_offset`` and the next at element ``idx`` of the
    ``[B, half]`` grid (``half = (d + 1) // 2``, seed unshifted) and takes
    ``r·sin`` where ``take_sin``, else ``r·cos``.  ``col`` is the layer's
    global column."""
    half = (int(dims[layer]) + 1) // 2
    take_sin = col >= half
    return 2 * layer, row * half + (col - half if take_sin else col), take_sin


def bf16_round(t: Tensor) -> Tensor:
    """``t`` rounded to bf16 (to nearest, ties to even) and held in its own
    dtype: a product's operand under ``bf16_matmul``."""
    return t.to(torch.bfloat16).to(t.dtype)


def _tf32_rna(x: Tensor) -> Tensor:
    """float32 ``x`` rounded to TF32 (10 explicit significand bits), to
    nearest with ties away from zero, as ``cvt.rna.tf32.f32``; non-finite
    values pass through."""
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def tf32_split(x: Tensor) -> tp.Tuple[Tensor, Tensor]:
    """``x`` as two TF32 halves, the operand split of split-TF32 products
    ("3xTF32"): ``hi`` = ``x`` rounded to TF32 and ``lo`` = ``x - hi``
    rounded so, both float32 with their low 13 bits clear, and ``|x - hi -
    lo| <= max(2^-22 |x|, 2^-137)`` for finite float32 ``x`` (the second
    term where ``x - hi`` is subnormal).  Non-finite values pass through
    ``hi``; their ``lo`` is NaN.  For tests and diagnosis: nothing on the
    main path calls it."""
    x = x.to(torch.float32)
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)


def tf32_split_matmul(a: Tensor, b: Tensor) -> Tensor:
    """``a @ b`` as split-TF32 products take it: ``a_lo b_hi + a_hi b_lo +
    a_hi b_hi`` of the split operands (:func:`tf32_split`), summed in
    float64 and rounded to float32.  It drops ``a_lo b_lo`` and the splits'
    own rounding, at most ``3 * 2^-22`` of each ``|a||b|`` term, and so
    shows what the split alone does, apart from how a tensor core's f32
    sums round.  For diagnosis: nothing on the main path calls it."""
    ah, al = (t.double() for t in tf32_split(a))
    bh, bl = (t.double() for t in tf32_split(b))
    return (al @ bh + ah @ bl + ah @ bh).float()


@dataclasses.dataclass
class StepTerms:
    """What one step computes from its pre-update latents ``X`` [..., N]
    (``N = d0 + d1 + d2``; any leading axes): ``H = act(X)``, the products'
    operands ``h`` (H split by layer, rounded to bf16 under ``bf16_matmul``),
    the errors, the logits (None without a sensory layer), the output-PC
    site's error ``err3`` and gradient ``G3``, ``S`` (None with loss
    ``"none"``), the backward products ``back``, ``dH = act'(X)`` and the
    latents' gradient ``G``."""

    H: Tensor
    h: tp.Tuple[Tensor, Tensor, Tensor]
    err0: Tensor
    e1: Tensor
    e2: Tensor
    logits: tp.Optional[Tensor]
    err3: tp.Optional[Tensor]
    S: tp.Optional[Tensor]
    back: Tensor
    dH: Tensor
    G: Tensor
    G3: tp.Optional[Tensor]


def step_terms(c: _Chain, weights, biases, X: Tensor, X3: tp.Optional[Tensor], y: Tensor,
               clamped: tp.Optional[Tensor], act, op=lambda t: t) -> StepTerms:
    """One step's forward and backward products of the plain version, on
    latents ``X`` [..., N] (and x3 [..., D]): ``weights`` ``(w1, w2, w3)``
    as the products take them, ``biases`` ``(b0, b1, b2, b3)``, ``y`` the
    target, ``clamped`` the masked loss's column mask or None, ``act`` the
    activation, ``op`` a product operand's rounding.  The constants
    (``inv_var``, ``inv_var3``) are ``c``'s.  Shared by
    :func:`mcpc_chain_reference` and the step rule (``step_rule.py``),
    which runs it in float64 on many steps at once."""
    d0, d1, d2, _ = c.dims
    w1, w2, w3 = weights
    b0, b1, b2, b3 = biases
    H = act(X)
    # the products' operands; act' and every sum take the unrounded values
    h0, h1, h2 = op(H).split((d0, d1, d2), dim=-1)
    err0 = X[..., :d0] - b0
    e1 = X[..., d0 : d0 + d1] - (h0 @ w1 + b1)
    e2 = X[..., d0 + d1 :] - (h1 @ w2 + b2)
    G3 = err3 = logits = None
    if c.output_pc:
        logits = h2 @ w3 + b3
        err3 = X3 - logits
        S = -err3 * c.inv_var3
        G3 = c.inv_var3 * err3
        back2 = op(-S) @ w3.T
    elif c.loss == "none":
        S = None
        back2 = torch.zeros_like(h2)
    else:
        logits = h2 @ w3 + b3
        if c.loss == "bernoulli":
            S = (0.5 + 0.5 * torch.tanh(0.5 * logits)) - y
        else:
            S = (logits - y) * c.inv_var
        if clamped is not None:
            S = S * clamped
        back2 = op(-S) @ w3.T
    back = torch.cat([op(e1) @ w1.T, op(e2) @ w2.T, back2], dim=-1)
    dH = (X > 0).to(X.dtype) if c.activation == "relu" else 1.0 - H * H
    G = torch.cat([err0, e1, e2], dim=-1) - dH * back
    return StepTerms(H, (h0, h1, h2), err0, e1, e2, logits, err3, S, back, dH, G, G3)


def adam_moments(m: Tensor, v: Tensor, G: Tensor, b1: float, b2: float, one_m_b1: float,
                 one_m_b2: float) -> tp.Tuple[Tensor, Tensor]:
    """The Adam moments after a warm step with gradient ``G``."""
    return b1 * m + one_m_b1 * G, b2 * v + one_m_b2 * G * G


def bias_corrections(c: _Chain) -> tp.Iterator[tp.Tuple[float, float]]:
    """``(1 - b1^k, 1 - b2^k)`` of each warm step, the powers carried step
    to step in float32 from ``c.bias0``, as the kernel carries them."""
    b1p, b2p = np.float32(c.bias0[0]), np.float32(c.bias0[1])
    for _ in range(c.warm_T):
        yield float(np.float32(1.0) - b1p), float(np.float32(1.0) - b2p)
        b1p = np.float32(b1p * np.float32(c.warm_b1))
        b2p = np.float32(b2p * np.float32(c.warm_b2))


def adam_step(x: Tensor, m: Tensor, v: Tensor, c1: float, c2: float, lr: float,
              eps: float) -> Tensor:
    """The warm step from the updated moments, in optax's operation order:
    ``x - lr * (m / c1) / (sqrt(v / c2) + eps)``."""
    return x - lr * (m / c1) / (torch.sqrt(v / c2) + eps)


def langevin_update(X: Tensor, G: Tensor, z: tp.Optional[Tensor], lr: float,
                    noise_std: float) -> Tensor:
    """A Langevin step: ``X - lr G``, then ``+ noise_std z`` where there is
    noise."""
    X = X - lr * G
    return X if z is None else X + noise_std * z


@torch.no_grad()
def _reference(c: _Chain, params, latents, target, warm_mu=None, warm_nu=None):
    d0, d1, d2, D = c.dims
    b0 = params[0]["b"]
    (w1, b1), (w2, b2), (w3, b3) = ((params[i]["w"], params[i]["b"])
                                    for i in (1, 2, 3))
    # a product's operand: rounded to bf16 under bf16_matmul (the weights
    # once, here), else as it is
    op = bf16_round if c.bf16_matmul else (lambda t: t)
    w1, w2, w3 = op(w1), op(w2), op(w3)
    act = activation_fn(c.activation)
    X = torch.cat(latents[:3], dim=1)
    X3 = latents[3] if c.output_pc else None  # the output-PC site's latent
    B = X.shape[0]
    y = target if target is not None else torch.zeros(
        (B, D), dtype=X.dtype, device=X.device)
    clamped = None  # the output columns the loss clamps, where masked
    if c.mask_lo:
        clamped = (torch.arange(D, device=X.device) >= c.mask_lo).to(X.dtype)

    flat = None
    if c.with_pgrads:
        flat = torch.zeros(sum(_partial_sizes(c.dims)), dtype=X.dtype,
                           device=X.device)

    def grads(X, X3, want_scalars: bool, sample: bool = False):
        """(G of the latents, G3 of x3 or None, scalars or None)."""
        s = step_terms(c, (w1, w2, w3), (b0, b1, b2, b3), X, X3, y, clamped, act, op)
        (h0, h1, h2), err0, e1, e2 = s.h, s.err0, s.e1, s.e2
        logits, err3, S, G, G3 = s.logits, s.err3, s.S, s.G, s.G3
        if sample:
            # Hebbian gradients from this (pre-update) state, over the batch
            gw1, gw2, gw3, gb0, gb1, gb2, gb3 = flat.split(_partial_sizes(c.dims))
            gw1 += (-(h0.T @ op(e1))).reshape(-1)
            gw2 += (-(h1.T @ op(e2))).reshape(-1)
            gb0 += (-err0).sum(dim=0)
            gb1 += (-e1).sum(dim=0)
            gb2 += (-e2).sum(dim=0)
            if S is not None:
                gw3 += (h2.T @ op(S)).reshape(-1)
                gb3 += S.sum(dim=0)
        if not want_scalars:
            return G, G3, None
        energy = 0.5 * (torch.sum(err0 * err0) + torch.sum(e1 * e1)
                        + torch.sum(e2 * e2))
        if err3 is not None:
            energy = energy + 0.5 * c.inv_var3 * torch.sum(err3 * err3)
        if c.loss == "bernoulli":
            elem = (torch.clamp(logits, min=0.0) - logits * y
                    + torch.log1p(torch.exp(-torch.abs(logits))))
        elif c.loss == "gaussian":
            elem = 0.5 * c.inv_var * (logits - y) ** 2
        if c.loss == "none":
            loss_s = torch.zeros((), dtype=X.dtype, device=X.device)
        else:
            loss_s = torch.sum(elem if clamped is None else elem * clamped)
        return G, G3, (loss_s, energy)

    traj = traj3 = None
    pD = _pad128(D)
    if c.capture_stride:
        _, _, XW = aligned_layout((d0, d1, d2))
        traj = X.new_zeros((c.n_cap, B, XW))
        if c.output_pc:
            traj3 = X.new_zeros((c.n_cap, B, pD))
    slots = [None] * c.n_slots
    final = None

    def observe(X, X3, cs: int, last: bool) -> bool:
        """Capture the step's pre-update latents; whether it wants sums."""
        if traj is not None and cs >= 0 and cs % c.capture_stride == 0:
            traj[cs // c.capture_stride] = _pack_aligned(
                X.split((d0, d1, d2), dim=1), (d0, d1, d2))
            if traj3 is not None:
                traj3[cs // c.capture_stride, :, :D] = X3
        slot = c.scalar_stride and cs >= 0 and cs % c.scalar_stride == 0
        return bool(slot) or (c.return_scalars and last)

    def record(cs: int, last: bool, sc) -> None:
        nonlocal final
        if c.scalar_stride:
            if cs >= 0 and cs % c.scalar_stride == 0:
                slots[cs // c.scalar_stride] = sc
            if last:
                slots[-1] = sc
        elif last:
            final = sc

    def padded(t):  # [B, D] -> [B, pD], pad lanes zero
        out = t.new_zeros((B, pD))
        out[:, :D] = t
        return out

    total = c.warm_T + c.T
    moments = None
    if c.warm_T > 0:
        sites = 4 if c.output_pc else 3
        if warm_mu is not None:
            m = torch.cat(warm_mu[:3], dim=1).to(X.dtype)
            v = torch.cat(warm_nu[:3], dim=1).to(X.dtype)
            m3, v3 = ((warm_mu[3].to(X.dtype), warm_nu[3].to(X.dtype))
                      if sites == 4 else (None, None))
        else:
            m = torch.zeros_like(X)
            v = torch.zeros_like(X)
            m3, v3 = (torch.zeros_like(X3), torch.zeros_like(X3)) if sites == 4 else (None, None)

        def adam(x, m, v, G, c1, c2):
            m, v = adam_moments(m, v, G, c.warm_b1, c.warm_b2, 1.0 - c.warm_b1,
                                1.0 - c.warm_b2)
            return adam_step(x, m, v, c1, c2, c.warm_lr, c.warm_eps), m, v

        for s, (c1, c2) in enumerate(bias_corrections(c)):
            cs, last = (s if c.T == 0 else -1), s == total - 1
            want = observe(X, X3, cs, last)
            G, G3, sc = grads(X, X3, want, c.warm_pgrads and s == c.warm_T - 1)
            if want:
                record(cs, last, sc)
            X, m, v = adam(X, m, v, G, c1, c2)
            if G3 is not None:
                X3, m3, v3 = adam(X3, m3, v3, G3, c1, c2)
        if c.emit_opt_state:
            moments = tuple(_pack_aligned(t.split((d0, d1, d2), dim=1), (d0, d1, d2))
                            for t in (m, v))
            if c.output_pc:
                moments += (padded(m3), padded(v3))

    noisy = c.noise_std > 0.0
    dp = 4 if c.output_pc else 2  # draws a step pair
    if noisy and c.packed and c.T > 0:
        idx, seeds = _noise_index(c, B, X.device)
        if c.output_pc:
            idx3 = _noise_index3(c, B, X.device)
        # both draws of a step pair in one call (the same operations on
        # every element as one draw a call)
        pair = torch.arange(2, dtype=torch.int64, device=X.device)[:, None, None]
    z_cos = z_sin = z3_cos = z3_sin = None
    for t in range(c.T):
        if noisy and c.packed and t % 2 == 0:
            p = t // 2
            bits = counter_bits_at(idx[None], seeds[None], dp * p + pair)
            z_cos, z_sin = box_muller(bits[0], bits[1])
            if c.output_pc:
                bits = counter_bits_at(idx3[None], seeds[None], dp * p + 2 + pair)
                z3_cos, z3_sin = box_muller(bits[0], bits[1])
        last = t == c.T - 1
        want = observe(X, X3, t, last)
        G, G3, sc = grads(X, X3, want, c.with_pgrads and t >= c.mixing)
        if want:
            record(t, last, sc)
        z = z3 = None
        if noisy and c.packed:
            z = z_cos if t % 2 == 0 else z_sin
            z3 = z3_cos if t % 2 == 0 else z3_sin
        elif noisy:
            z = _unpacked_normals(c, B, t, X.device)
        X = langevin_update(X, G, z, c.lr, c.noise_std)
        if G3 is not None:
            X3 = langevin_update(X3, G3, z3, c.lr, c.noise_std)

    scalars = None
    if c.return_scalars:
        zero = torch.zeros((), dtype=X.dtype, device=X.device)
        rows = slots if c.scalar_stride else [final or (zero, zero)]
        scalars = {"loss": torch.stack([r[0] for r in rows]),
                   "energy": torch.stack([r[1] for r in rows])}
        if traj is not None:
            scalars = _with_capture_rows(scalars, traj, params, target, c, traj3)
    new = tuple(x.contiguous() for x in X.split((d0, d1, d2), dim=1))
    if c.output_pc:
        new += (X3.contiguous(),)
    pgrads = None if flat is None else _pgrads_from_flat(flat, params, c.dims)
    return _result(c, new, pgrads, traj, traj3, scalars, moments)


def _with_capture_rows(final, traj, params, target, c: _Chain, traj3=None):
    """A capture run's scalars: the recomputed rows of the captured steps,
    then the kernel's final-step row (the JAX wrapper's order)."""
    loss, energy = traj_scalar_rows(traj, params, target, c, traj3)
    return {"loss": torch.cat([loss.to(final["loss"].dtype), final["loss"]]),
            "energy": torch.cat([energy.to(final["energy"].dtype), final["energy"]])}


def mcpc_chain_reference(params, latents, target, seed, **options):
    """Plain PyTorch version of :func:`mcpc_chain`: the same arguments, the
    same arithmetic, on any device.  The tests and ``chip_smoke.py`` hold the
    kernel against it."""
    return _reference(_chain_args(params, latents, target, seed, **options),
                      params, latents, target, options.get("warm_mu"),
                      options.get("warm_nu"))


# -------------------------------------------------------------- kernels

CLUSTER_SIZE = 8  # blocks a cluster: the most every Hopper card must take
# Rows a cluster for which the kernel is built (``MCPC_CLUSTER_ROWS`` in
# ``csrc/mcpc_cluster.cuh``): what the plan's rule picks at B >= 136 (18), from 61
# (10), from 31 (4) and below (2) on a card that runs 15 clusters at once.
CLUSTER_ROWS = (18, 10, 4, 2)
# What a step costs beyond its rows' products, in rows: the barriers, and the
# weights' way from shared memory into registers, which every row shares.  On
# an H100 a step of one wave took 11,331 SM clocks at 2 rows and 23,067 at 18
# (``scripts/chain_clocks.py --rows``): 733 clocks a row on top of 9,864.
# With the f32 products retiled (PERF.md §6) 8,786 and 19,090: 644 a row on
# top of 7,498, 11.6 rows; 12 gives every batch up to 4096 the plan 13 gives.
_ROW_OVERHEAD = 13
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_Z = ctypes.c_size_t


@dataclasses.dataclass(frozen=True)
class ChainPlan:
    """How the cluster kernel (packed or unpacked) maps one call onto the
    card."""

    cluster_size: int   # blocks a cluster
    rows: int           # batch rows a cluster
    clusters: int       # ceil(B / rows)
    # per layer (x0, x1, x2, output): each rank's (first column, end); the
    # kernel takes its slices from here
    slices: tp.Tuple[tp.Tuple[tp.Tuple[int, int], ...], ...]
    smem_bytes: int     # dynamic shared memory a block
    grads_resident: bool  # a block's gradient slice stays in shared memory

    @property
    def blocks(self) -> int:
        return self.clusters * self.cluster_size

    def slice_bounds(self) -> tp.List[int]:
        """The slices as the kernel takes them: per layer the first column of
        every rank's slice and, last, the layer's width."""
        return [lo for layer in self.slices
                for lo in [first for first, _ in layer] + [layer[-1][1]]]

    def describe(self, max_clusters: tp.Optional[int] = None) -> str:
        """One line for logs; ``max_clusters`` (what the card runs at once)
        adds the number of SMs at work."""
        text = (f"cluster of {self.cluster_size} blocks, {self.rows} rows a "
                f"cluster, {self.clusters} clusters")
        if max_clusters is not None:
            text += (f", {min(self.clusters, max_clusters) * self.cluster_size}"
                     f" SMs at work (the card runs {max_clusters} clusters at once)")
        return (f"{text}, {self.smem_bytes} B shared memory a block, gradient "
                f"slice {'resident' if self.grads_resident else 'not resident'}")


def column_slices(d: int, ranks: int = CLUSTER_SIZE) -> tp.Tuple[tp.Tuple[int, int], ...]:
    """``d`` columns cut into ``ranks`` contiguous ``(first, end)`` slices,
    as even as possible: the first ``d % ranks`` take one column more.  With
    ``d < ranks`` the last ranks get an empty slice."""
    q, rem = divmod(d, ranks)
    lo = [k * q + min(k, rem) for k in range(ranks + 1)]
    return tuple((lo[k], lo[k + 1]) for k in range(ranks))


def chain_smem_bytes(dims, rows: int, warm: bool, grads: int,
                     output_pc: bool = False, bf16: bool = False) -> int:
    """Dynamic shared memory of one block of the cluster kernel (the layout of
    ``make_layout`` in ``csrc/mcpc_cluster.cuh``, whose launches refuse a
    plan sized otherwise).  ``grads``: 0 no parameter gradients, 1 the
    block's gradient slice in device memory, 2 in shared memory;
    ``output_pc``: the own columns of an output-PC latent (and, warm, their
    Adam moments); ``bf16``: the bf16 build's layout, whose products read
    bf16 copies of act(X), of the own errors and S, and of the weight
    slices."""
    d0, d1, d2, D = dims
    n0, n1, n2, nD = (-(-d // CLUSTER_SIZE) for d in dims)  # widest slices
    own = n0 + n1 + n2

    def stride(width):  # a slice's row stride: the least 8 * odd that holds it
        return 8 * (-(-width // 8) | 1)

    weights = d0 * stride(n1) + d1 * stride(n2) + d2 * stride(nD)
    # a feature's rows are kept at a pitch of whole float4s once a half of
    # them holds a float4
    pitch = -(-rows // 4) * 4 if rows >= 8 else rows
    by_row = pitch * (
        (2 + (2 if warm else 0)) * own     # own X, errors, Adam moments
        + nD                               # own S
        + CLUSTER_SIZE * own               # the ranks' partial backward products
        # an output-PC site's own columns and, warm, their Adam moments
        + ((3 if warm else 1) * nD if output_pc else 0)
    )
    floats = (
        own + nD                           # own biases
        + d0 + d1 + d2                     # every latent column's owner
        + (weights if grads == 2 else 0)   # gradient slices, f32 in both builds
        + (own + nD if grads else 0)
    )
    if not bf16:
        # the step's two mbarriers (4 floats) first, then act(X) with the
        # arrays above; the weight slices start at a whole float4
        by_row += (d0 + d1 + d2) * pitch
        return 4 * (4 + -(-by_row // 4) * 4 + weights + floats)

    def up16(d):
        return -(-d // 16) * 16

    # the rows padded to whole n8 tiles, at a pitch of 8 * odd bf16
    rn = -(-rows // 8) * 8
    hp = rn if rn // 8 % 2 else rn + 8
    halves = (
        (up16(d0) + up16(d1) + up16(d2)) * hp         # act(X), each layer padded to 16
        + (up16(n1) + up16(n2) + up16(nD)) * hp       # own err1, err2, S
        # weight slices: rows padded to 16, strides up16(width) + 8
        + up16(d0) * (up16(n1) + 8) + up16(d1) * (up16(n2) + 8) + up16(d2) * (up16(nD) + 8)
    )
    return 4 * (by_row + floats) + 2 * halves


def chain_plan(dims, B: int, *, warm: bool, with_pgrads: bool, budget: int,
               max_clusters: int,
               row_counts: tp.Sequence[int] = CLUSTER_ROWS,
               output_pc: bool = False, bf16: bool = False) -> ChainPlan:
    """The cluster kernel's plan for ``dims = (d0, d1, d2, D)`` and batch
    ``B``, given ``budget`` bytes of dynamic shared memory a block and the
    ``max_clusters`` the card runs at once (15 on an H100 SXM: its 132 SMs
    come in groups of which one holds fewer than 16).

    Rows a cluster: of the counts in ``CLUSTER_ROWS`` whose block fits the
    budget, the one with the least ``waves * (rows + 8)``, where ``waves =
    ceil(ceil(B / rows) / max_clusters)`` is how often the card must be
    filled and 13 rows stand for what a step costs whatever its rows; ties go
    to more rows.  At B=256 that is 18 rows: 15 clusters, one wave, 120 SMs
    (16 rows would be 16 clusters and a second wave for the last one).  A
    small batch takes few rows a cluster and so more SMs.  The gradient
    slice is resident when it fits beside the weights at that row count,
    else it stays in device memory.  ``output_pc`` sizes the blocks for an
    output-PC site, ``bf16`` for the bf16 build's layout (pass that
    library's budget and cluster count).  Raises ``ValueError`` when not
    even two rows fit."""
    if B < 1 or max_clusters < 1:
        raise ValueError("chain_plan needs a batch and a cluster count of at least 1")
    dims = tuple(int(d) for d in dims)
    options = (2, 1) if with_pgrads else (0,)
    best = None
    for rows in row_counts:
        fits = [(g, chain_smem_bytes(dims, rows, warm, g, output_pc, bf16)) for g in options]
        fits = [(g, need) for g, need in fits if need <= budget]
        if not fits:
            continue
        clusters = -(-B // rows)
        cost = -(-clusters // max_clusters) * (rows + _ROW_OVERHEAD)
        if best is None or cost < best[0]:
            best = (cost, rows, clusters) + fits[0]
    if best is None:
        least = chain_smem_bytes(dims, min(row_counts), warm, options[-1], output_pc, bf16)
        raise ValueError(
            f"dims {dims} need {least} bytes of shared memory a block at "
            f"{min(row_counts)} rows a cluster; the budget is {budget}")
    _, rows, clusters, grads, need = best
    return ChainPlan(
        cluster_size=CLUSTER_SIZE, rows=rows, clusters=clusters,
        slices=tuple(column_slices(d) for d in dims),
        smem_bytes=need, grads_resident=grads == 2,
    )


def _prefix(packed: bool) -> str:
    """Source name and C-symbol prefix of the packed or unpacked kernel."""
    return "mcpc_chain" if packed else "mcpc_chain_unpacked"


@functools.lru_cache(maxsize=None)
def _library(packed: bool = True, bf16: bool = False,
             warp_clocks: bool = False) -> ctypes.CDLL:
    """The packed or unpacked kernel's library (with ``bf16``, the one whose
    kernels take bf16 operands; with ``warp_clocks``, the profiling build
    that also times each warp), built at first use, with its C signatures.
    The packed libraries also hold the pass that sums the partial
    gradients."""
    from . import _build

    name = _prefix(packed)
    lib = _build.load(name, bf16, warp_clocks)
    launch = getattr(lib, name + "_launch")
    launch.restype = _I
    smem_bytes = getattr(lib, name + "_smem_bytes")
    smem_bytes.restype = _Z
    budget = getattr(lib, name + "_smem_budget")
    budget.restype = _I
    budget.argtypes = [_I]
    max_clusters = getattr(lib, name + "_max_clusters")
    max_clusters.restype = _I
    max_clusters.argtypes = [_I, _Z]
    if packed:
        launch.argtypes = ([_P] * 30 + [ctypes.POINTER(_I)] + [_I] * 18 + [_F] * 11
                           + [_I, _I, _Z, _P])
        smem_bytes.argtypes = [_I] * 8
        counts = [lib.mcpc_chain_cluster_size, lib.mcpc_chain_phase_count,
                  lib.mcpc_chain_block_threads]
        if warp_clocks:
            counts.append(lib.mcpc_chain_warp_clock_count)
        for count in counts:
            count.restype = _I
            count.argtypes = []
        for summing in (lib.mcpc_sum_partials_launch, lib.mcpc_sum_partials_f64_launch):
            summing.restype = _I
            summing.argtypes = [_P, _P, _I, _Z, _P]
    else:
        launch.argtypes = ([_P] * 15 + [ctypes.POINTER(_I)] + [_I] * 10 + [_F] * 3
                           + [_I, _Z, _P])
        smem_bytes.argtypes = [_I] * 6
    error_string = getattr(lib, name + "_error_string")
    error_string.restype = ctypes.c_char_p
    error_string.argtypes = [_I]
    return lib


def block_threads(bf16: bool = False) -> int:
    """Threads a block of the chain kernels of the f32 (or bf16) build, as
    that build's library reports them."""
    return _library(True, bf16).mcpc_chain_block_threads()


def _error_message(err: int, packed: bool = True) -> str:
    name = _prefix(packed)
    return getattr(_library(packed), name + "_error_string")(err).decode()


def _check_launch(err: int, packed: bool = True) -> None:
    if err != 0:
        raise RuntimeError(f"{_prefix(packed)} kernel launch failed: "
                           f"{_error_message(err, packed)} ({err})")


_NO_GUARD = contextlib.nullcontext()


def _on(index: int):
    """A guard that makes CUDA device ``index`` current, or nothing where it
    is: entering ``torch.cuda.device`` costs the host about half of what the
    summing pass takes on the card, this check a quarter of that."""
    return _NO_GUARD if index == torch.cuda.current_device() else torch.cuda.device(index)


def _raw_stream(index: int) -> int:
    """The current stream of CUDA device ``index`` as the handle a launch
    takes.  ``torch.cuda.current_stream`` builds a Stream object for it, at
    as much host time as the device guard; where this PyTorch has the plain
    getter, which costs next to nothing, that is used."""
    getter = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if getter is not None:
        return getter(index)
    return torch.cuda.current_stream(index).cuda_stream


def _device_index(device) -> int:
    index = torch.device(device).index
    return torch.cuda.current_device() if index is None else index


@functools.lru_cache(maxsize=None)
def _smem_budget_of(index: int, packed: bool = True, bf16: bool = False) -> int:
    budget = getattr(_library(packed, bf16), _prefix(packed) + "_smem_budget")(index)
    if budget < 0:
        raise RuntimeError("could not query the device's shared memory")
    return budget


def smem_budget(device, packed: bool = True, bf16: bool = False) -> int:
    """Bytes of dynamic shared memory one block of the packed (or, with
    ``packed=False``, the unpacked) kernel may use on the CUDA ``device``:
    the ``budget`` of :func:`chain_plan`.  ``bf16`` asks the bf16 library's
    own instantiation."""
    return _smem_budget_of(_device_index(device), packed, bf16)


@functools.lru_cache(maxsize=None)
def _max_clusters_of(index: int, rows: int, smem_bytes: int, packed: bool = True,
                     bf16: bool = False) -> int:
    with torch.cuda.device(index):
        count = getattr(_library(packed, bf16),
                        _prefix(packed) + "_max_clusters")(rows, smem_bytes)
    if count < 0:
        raise RuntimeError("the cluster occupancy query failed: "
                           f"{_error_message(-count, packed)} ({-count})")
    if count == 0:
        raise RuntimeError(
            f"the device cannot run one cluster of {CLUSTER_SIZE} blocks with "
            f"{smem_bytes} bytes of shared memory a block")
    return count


def max_active_clusters(device, plan: tp.Optional[ChainPlan] = None,
                        packed: bool = True, bf16: bool = False) -> int:
    """Clusters of the packed (or, with ``packed=False``, the unpacked)
    kernel (with ``bf16``, of its bf16 build) that the CUDA ``device`` runs
    at once, asked of CUDA once per shape of that kernel's own
    instantiation: those of ``plan``, or without one those of the largest
    block, the ``max_clusters`` of :func:`chain_plan`.  Raises when the
    device cannot run even one."""
    index = _device_index(device)
    if plan is None:
        return _max_clusters_of(index, CLUSTER_ROWS[0], _smem_budget_of(index, packed, bf16),
                                packed, bf16)
    return _max_clusters_of(index, plan.rows, plan.smem_bytes, packed, bf16)


def plan_options(c: _Chain) -> tp.Dict[str, bool]:
    """The keywords of :func:`chain_plan` for a validated call, packed or
    not.  An unpacked call has no warm phase and no output-PC site, so its
    plan is ``chain_plan(dims, B, warm=False, with_pgrads=...)``."""
    return dict(warm=c.warm_T > 0, with_pgrads=c.with_pgrads, output_pc=c.output_pc)


@functools.lru_cache(maxsize=None)
def _device_plan_of(index: int, dims, B: int, warm: bool, with_pgrads: bool,
                    output_pc: bool, packed: bool, bf16: bool,
                    row_counts: tp.Tuple[int, ...]) -> ChainPlan:
    return chain_plan(dims, B, warm=warm, with_pgrads=with_pgrads,
                      budget=_smem_budget_of(index, packed, bf16),
                      max_clusters=max_active_clusters(index, packed=packed, bf16=bf16),
                      row_counts=row_counts, output_pc=output_pc, bf16=bf16)


def device_plan(c: _Chain, B: int, device,
                row_counts: tp.Sequence[int] = CLUSTER_ROWS) -> ChainPlan:
    """:func:`chain_plan` of a validated call on the CUDA ``device``, with
    the layout, the budget and the cluster count of the call's own kernel
    (packed or unpacked, f32 or bf16)."""
    o = plan_options(c)
    return _device_plan_of(_device_index(device), c.dims, B, o["warm"], o["with_pgrads"],
                           o["output_pc"], c.packed, c.bf16_matmul, tuple(row_counts))


def sum_block_partials_reference(partials: Tensor) -> Tensor:
    """Plain version of :func:`sum_block_partials`: the same additions in
    the same order, so the two agree bit for bit."""
    out = partials[0].clone()
    for b in range(1, partials.shape[0]):
        out += partials[b]
    return out


def sum_block_partials(partials: Tensor) -> Tensor:
    """Sum ``[n_blocks, n]`` partial gradients (one per cluster of the chain
    kernel) over the blocks, in block order:
    the second pass of the parameter gradients, which takes the
    place of the TPU kernel's accumulators carried across batch tiles
    (``pallas_mcpc.py``, ``pl.when(tile_i == 0)``).  float32, or float64 for
    the per-step scalar slots.  CUDA tensors launch ``sum_partials_kernel``
    (``csrc/mcpc_chain.cu``) or raise; CPU tensors run the plain version.
    ``sum_block_partials.launches`` counts launches.
    """
    if partials.dim() != 2 or partials.shape[0] < 1 or partials.shape[1] < 1:
        raise ValueError("sum_block_partials takes a [n_blocks, n] tensor")
    device = partials.device
    if device.type == "cpu":
        return sum_block_partials_reference(partials)
    if device.type != "cuda":
        raise ValueError(f"sum_block_partials runs on cpu or cuda, not {device.type}")
    if partials.dtype == torch.float32:
        launch = _library().mcpc_sum_partials_launch
    elif partials.dtype == torch.float64:
        launch = _library().mcpc_sum_partials_f64_launch
    else:
        raise TypeError(f"sum_block_partials takes float32 or float64, got {partials.dtype}")
    partials = partials.contiguous()
    nblocks, n = partials.shape
    out = torch.empty(n, dtype=partials.dtype, device=device)
    with _on(device.index):
        err = launch(partials.data_ptr(), out.data_ptr(), nblocks, n,
                     _raw_stream(device.index))
    _check_launch(err)
    sum_block_partials.launches += 1
    return out


sum_block_partials.launches = 0


# the parts of a step that :func:`chain_phase_clocks` tells apart
PHASES = ("forward", "gradients", "backward", "wait for partials", "update",
          "wait for relu(x)")


def _kernel(c: _Chain, params, latents, target, clocks: tp.Optional[Tensor] = None,
            plan: tp.Optional[ChainPlan] = None, warm_mu=None, warm_nu=None,
            warp_clocks: bool = False):
    """Launch the packed or unpacked kernel, f32 or bf16, on CUDA tensors,
    with ``plan`` or the call's own :func:`device_plan` (``warp_clocks``:
    from the profiling build)."""
    d0, d1, d2, D = c.dims
    device = latents[0].device
    tensors = list(latents) + [t for p in params for t in p.values()]
    if target is not None:
        tensors.append(target)
    if warm_mu is not None:
        tensors += list(warm_mu) + list(warm_nu)
    for t in tensors:
        if t.device != device:
            raise ValueError("mcpc_chain: all tensors must be on one device")
        if t.dtype != torch.float32:
            raise TypeError(f"mcpc_chain takes float32 tensors, got {t.dtype}")
    B = latents[0].shape[0]
    x0, x1, x2 = (x.contiguous() for x in latents[:3])
    x3 = latents[3].contiguous() if c.output_pc else None
    b0, b1, b2, b3 = (p["b"].contiguous() for p in params)
    w1, w2, w3 = (params[i]["w"].contiguous() for i in (1, 2, 3))
    if c.bf16_matmul:
        # the weights as the products take them, rounded once per call, as
        # the JAX wrapper stages them; gradients, scalars and the result keep
        # the f32 parameters
        w1, w2, w3 = (bf16_round(w) for w in (w1, w2, w3))
    # the output-PC site reads x3 where the loss reads the target
    y = (target.contiguous() if target is not None else x3 if x3 is not None
         else torch.zeros((B, D), dtype=torch.float32, device=device))
    outs = [torch.empty_like(x) for x in (x0, x1, x2)]
    pointers = [t.data_ptr() for t in (x0, x1, x2, *outs, y, b0, b1, b2, b3, w1, w2, w3)]
    plan = device_plan(c, B, device) if plan is None else plan
    # raises if not even one cluster runs
    max_active_clusters(device, plan, packed=c.packed, bf16=c.bf16_matmul)
    # every cluster zeroes and fills its own partial gradients
    partials = None
    if c.with_pgrads:
        partials = torch.empty((plan.clusters, sum(_partial_sizes(c.dims))),
                               dtype=torch.float32, device=device)
    partials_ptr = None if partials is None else partials.data_ptr()
    lib = _library(c.packed, c.bf16_matmul, warp_clocks)
    XW = aligned_layout((d0, d1, d2))[2]
    pD = _pad128(D)
    # the options' buffers: the kernel writes only real columns and rows, so
    # the aligned outputs start at zero
    m_in = v_in = moments = traj = traj3 = slots = None
    m3_in = v3_in = o3 = None
    if c.packed:
        if warm_mu is not None:
            m_in, v_in = (_pack_aligned([m.contiguous() for m in ms[:3]], (d0, d1, d2))
                          for ms in (warm_mu, warm_nu))
            if c.output_pc:
                m3_in, v3_in = (_pack_aligned([ms[3].contiguous()], (D,))
                                for ms in (warm_mu, warm_nu))
        if c.emit_opt_state:
            widths = (XW, XW, pD, pD) if c.output_pc else (XW, XW)
            moments = tuple(torch.zeros((B, w), dtype=torch.float32, device=device)
                            for w in widths)
        if c.capture_stride:
            traj = torch.zeros((c.n_cap, B, XW), dtype=torch.float32, device=device)
            if c.output_pc:
                traj3 = torch.zeros((c.n_cap, B, pD), dtype=torch.float32, device=device)
        if c.scalar_stride:
            slots = torch.empty((plan.blocks, 2 * c.n_slots), dtype=torch.float64,
                                device=device)
        if c.output_pc:
            o3 = torch.empty_like(x3)

    def ptr(t):
        return None if t is None else t.data_ptr()

    bounds = plan.slice_bounds()
    with _on(device.index):
        stream = _raw_stream(device.index)
        if c.packed:
            scal = torch.zeros((plan.blocks, 2), dtype=torch.float64, device=device)
            m_out = (None,) * 4 if moments is None else tuple(moments) + (None,) * 2
            err = lib.mcpc_chain_launch(
                *pointers, scal.data_ptr(), partials_ptr, ptr(clocks),
                ptr(m_in), ptr(v_in), ptr(m_out[0]), ptr(m_out[1]),
                ptr(traj), ptr(slots),
                ptr(x3), ptr(o3), ptr(m3_in), ptr(v3_in), ptr(m_out[2]), ptr(m_out[3]),
                ptr(traj3),
                (_I * len(bounds))(*bounds),
                B, d0, d1, d2, D,
                c.T, c.warm_T, _LOSS_CODES[c.loss], int(c.return_scalars),
                c.mixing, int(c.warm_pgrads), plan.rows, int(plan.grads_resident),
                c.capture_stride, c.scalar_stride, c.n_slots, c.mask_lo,
                _ACT_CODES[c.activation],
                c.inv_var3 if c.output_pc else c.inv_var, c.lr, c.noise_std,
                c.warm_lr, c.warm_b1, c.warm_b2,
                1.0 - c.warm_b1, 1.0 - c.warm_b2, c.warm_eps,
                c.bias0[0], c.bias0[1],
                c.seed, c.tile, plan.smem_bytes, stream,
            )
        else:
            err = lib.mcpc_chain_unpacked_launch(
                *pointers, partials_ptr, (_I * len(bounds))(*bounds),
                B, d0, d1, d2, D, c.T, _LOSS_CODES[c.loss], c.mixing,
                plan.rows, int(plan.grads_resident),
                c.inv_var, c.lr, c.noise_std, c.seed, plan.smem_bytes, stream,
            )
    _check_launch(err, c.packed)
    counter = ("launches" if c.packed else "launches_unpacked") + (
        "_bf16" if c.bf16_matmul else "")
    setattr(mcpc_chain, counter, getattr(mcpc_chain, counter) + 1)
    scalars = None
    if c.scalar_stride:
        # the blocks' pairs added in block order
        sums = sum_block_partials(slots).view(c.n_slots, 2).to(torch.float32)
        scalars = {"loss": sums[:, 0].contiguous(), "energy": sums[:, 1].contiguous()}
    elif c.return_scalars:
        sums = scal.sum(dim=0).to(torch.float32)
        scalars = {"loss": sums[0:1], "energy": sums[1:2]}
        if traj is not None:
            scalars = _with_capture_rows(scalars, traj, params, target, c, traj3)
    pgrads = None
    if partials is not None:
        pgrads = _pgrads_from_flat(sum_block_partials(partials), params, c.dims)
    new = tuple(outs) + ((o3,) if o3 is not None else ())
    return _result(c, new, pgrads, traj, traj3, scalars, moments)


# what the profiling build adds up for each warp (``WARP_CLOCKS``)
WARP_PARTS = ("to first forward job", "forward jobs", "backward jobs")


def chain_phase_clocks(params, latents, target, seed, *,
                       rows: tp.Optional[int] = None, warps: bool = False, **options):
    """Where the packed kernel's time goes: run :func:`mcpc_chain` on CUDA
    tensors and return ``[blocks, len(PHASES)]`` int64 SM clocks, what
    thread 0 of each block spent in each part of the steps (waits at the
    barriers included), summed over the chain.  ``rows`` (one of
    ``CLUSTER_ROWS``) forces the rows a cluster instead of the plan's own
    choice; ``bf16_matmul=True`` times the bf16 build.  ``warps=True`` runs
    the f32 kernel's profiling build (``-DMCPC_WARP_CLOCKS``) and returns
    ``(phases, per_warp)``, ``per_warp`` ``[blocks, warps, len(WARP_PARTS)]``:
    each warp's clocks from the step's start to its first forward job, over
    its forward jobs and over its backward jobs, summed over the chain.  A
    profiling aid: the chain's results are dropped."""
    c = _chain_args(params, latents, target, seed, **options)
    device = latents[0].device
    if device.type != "cuda" or not c.packed:
        raise ValueError("chain_phase_clocks times the packed kernel on CUDA tensors")
    if warps and c.bf16_matmul:
        raise ValueError("the per-warp clocks time the f32 build")
    lib = _library(warp_clocks=warps)
    if lib.mcpc_chain_phase_count() != len(PHASES):
        raise RuntimeError("PHASES does not name the kernel's phases")
    extra = lib.mcpc_chain_warp_clock_count() if warps else 0
    plan = device_plan(c, latents[0].shape[0], device,
                       CLUSTER_ROWS if rows is None else (rows,))
    clocks = torch.zeros((plan.blocks, len(PHASES) + extra), dtype=torch.int64,
                         device=device)
    _kernel(c, params, latents, target, clocks, plan, warp_clocks=warps)
    if not warps:
        return clocks
    per_warp = clocks[:, len(PHASES):].reshape(plan.blocks, -1, len(WARP_PARTS))
    return clocks[:, :len(PHASES)], per_warp


def mcpc_chain(params, latents, target, seed, **options):
    """Run (optionally) ``warm_T`` Adam MAP steps, then ``T`` Langevin steps.

    Args:
        params: 4 ``{"w": [in, out], "b": [out]}`` dicts (the canonical MLP;
            ``params[0]["w"]`` is unused, its input being zeros).
        latents: ``(x0, x1, x2)``, each ``[B, d_l]`` float32, and with
            ``output_var`` the output-PC latent ``x3`` ``[B, D]`` fourth.
        target: ``[B, D]`` float32, or None for zeros.
        seed: int (or 0-d tensor) keying the noise stream.

    Keyword options, as ``mcpc_chain_pallas``: ``T``, ``lr``,
    ``noise_var=2.0`` (None or 0: no noise), ``loss`` in ``"bernoulli"``,
    ``"gaussian"``, ``"none"``, ``"bernoulli_mask"``, ``"gaussian_mask"``
    (with ``mask_perc``: only the last ``round(D * mask_perc)`` output
    columns are clamped, all of them when that rounds to 0),
    ``input_var=1.0``, ``warm_T=0``, ``warm_lr=0.1``, ``warm_b1=0.9``,
    ``warm_b2=0.999``, ``warm_eps=1e-8``, ``activation="relu"`` (or
    ``"tanh"``), ``output_var=None`` (the variance of a trailing output-PC
    site: ``loss="none"``, ``packed=True``, a fourth latent),
    ``return_scalars=False``, ``batch_tile=None`` (keys the per-tile noise
    seeds), and
    ``with_pgrads=False``: also sum the Hebbian parameter gradients over the
    Langevin steps ``t >= mixing`` (``mixing=0``);
    ``warm_pgrads=False``: also take them on the last warm step (needs
    ``with_pgrads`` and ``warm_T > 0``; with ``T=0`` that is one PC training
    step);
    ``capture_stride=0``: return the pre-update latents of every
    ``capture_stride``-th step of the Langevin phase (of the warm phase when
    ``T=0``) as ``traj`` ``[n_cap, B, XW]`` in the aligned packed layout of
    :func:`aligned_layout`, pad lanes 0;
    ``scalar_stride=0``: with ``return_scalars``, the scalars of every
    ``scalar_stride``-th step of that phase plus the final step's
    (:func:`scalar_slots` rows);
    ``emit_warm_opt_state=False``: also return the Adam moments after the
    warm phase, ``(m, v)``, each ``[B, XW]`` aligned (with an output-PC
    site ``(m, v, m3, v3)``, the last two ``[B, pD]``, pD = D padded to 128);
    ``warm_mu``/``warm_nu`` (tensors shaped like the latents) and
    ``warm_count``: resume an Adam state of ``warm_count`` steps;
    ``packed=True``: False runs the unpacked chain (the JAX package's
    ``_make_kernel``), which has relu, no warm phase, no scalars, no
    options, one batch tile and a noise stream of its own
    (:func:`unpacked_noise_site`);
    ``bf16_matmul=False``: True gives every matrix product bf16 operands
    with f32 sums, packed or not (the module docstring says which operands);
    on CUDA tensors it launches the kernels' bf16 build.

    Returns ``latents', pgrads[, traj[, traj3]][, scalars][, moments]``
    (``traj3`` ``[n_cap, B, pD]``: the output-PC latent's captures), in that
    order, each present only with its option.  ``pgrads`` is None unless
    ``with_pgrads``; else a tuple of four ``{"w", "b"}`` dicts shaped like
    ``params``, sums over the whole batch and the sampling steps (not
    divided by either), ``pgrads[0]["w"]`` zeros.  ``scalars`` is
    ``{"loss": [R], "energy": [R]}``, batch sums before a step's update:
    ``R = 1`` (the final step), or with captures the captured steps
    (recomputed from ``traj``) and then the final step, or with
    ``scalar_stride`` its slots.

    CPU tensors run :func:`mcpc_chain_reference`; CUDA tensors launch the
    kernel or raise.  ``mcpc_chain.launches`` counts launches of the packed
    kernel, ``mcpc_chain.launches_unpacked`` those of the unpacked one, and
    ``launches_bf16`` / ``launches_unpacked_bf16`` those of their bf16
    builds.
    """
    with span("mcpc.chain"):
        c = _chain_args(params, latents, target, seed, **options)
        device = latents[0].device
        moments = options.get("warm_mu"), options.get("warm_nu")
        if device.type == "cpu":
            return _reference(c, params, latents, target, *moments)
        if device.type == "cuda":
            return _kernel(c, params, latents, target, None, None, *moments)
        raise ValueError(f"mcpc_chain runs on cpu or cuda, not {device.type}")


mcpc_chain.launches = 0
mcpc_chain.launches_unpacked = 0
mcpc_chain.launches_bf16 = 0
mcpc_chain.launches_unpacked_bf16 = 0
