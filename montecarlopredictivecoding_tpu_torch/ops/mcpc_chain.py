"""Fused whole-chain MCPC: the Hopper kernel's wrapper, its plain PyTorch
version, and the counter-hash noise both of them use.

``mcpc_chain`` runs (optionally) ``warm_T`` Adam MAP steps on the latents,
then ``T`` Langevin steps, over the canonical generative MLP

    zeros -> Linear(d0,d0) -> PC(x0) -> relu -> Linear(d0,d1) -> PC(x1)
          -> relu -> Linear(d1,d2) -> PC(x2) -> relu -> Linear(d2,D) -> loss

with the closed-form energy gradient

    err0 = x0 - b0;  err_l = x_l - (relu(x_{l-1}) W_l + b_l)
    S    = sigmoid(logits) - y | (logits - y)/input_var | 0
    G    = [err0 | err1 | err2] - relu'(x) * [err1 W1ᵀ | err2 W2ᵀ | -S W3ᵀ]

On CUDA tensors it launches the hand-written kernel
(``csrc/mcpc_chain.cu``), which replaces the JAX package's Pallas kernel
``ops/pallas_mcpc.py::_make_packed_kernel``; on CPU tensors it runs
:func:`mcpc_chain_reference`, the same arithmetic in plain PyTorch.  There is
no fallback from one to the other.

Noise.  Both versions draw the Langevin noise from the stateless counter
hash of the JAX package's interpret mode (``_fmix32``, ``_mock_bits``,
``_uniforms``, ``_sincos_2pi``), with its indexing: the seed of a batch tile
is ``seed + tile_i``, an element's index is ``local_row * XW + padded_col``
over the 128-padded packed layout of :func:`aligned_layout`, and Langevin
step pair ``p`` reads draws ``2p`` and ``2p+1`` (step ``2p`` takes ``r·cos``,
step ``2p+1`` ``r·sin``).  So the port's chain equals
``mcpc_chain_pallas(..., interpret=True)`` element by element, up to f32
rounding.  Nothing is stored padded: the padding enters only the index.

The hash is 32-bit unsigned arithmetic.  ``torch.uint32`` lacks the needed
ops, so the PyTorch version keeps the values in int64 and reduces mod 2**32,
splitting each multiplication so no intermediate exceeds 2**49.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import typing as tp

import numpy as np
import torch

from ..core.model import PCModel
from ..core.modules import PC, Activation, gaussian_energy

Tensor = torch.Tensor

_SUPPORTED_ACTS = ("relu",)  # tanh: ROADMAP.md queue 2 item e
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

# keyword -> (value that means "off", the ROADMAP.md item that ports it)
_UNPORTED = {
    "with_pgrads": (False, "queue 2 item a (Hebbian pgrads, the training slice)"),
    "capture_stride": (0, "queue 2 item d (captures)"),
    "scalar_stride": (0, "queue 2 item c (per-step scalars)"),
    "output_var": (None, "queue 2 item e (output-PC site)"),
    "mask_perc": (None, "queue 2 item e (masked losses)"),
    "bf16_matmul": (False, "queue 2, the bf16 opt-in"),
    "packed": (True, "queue 2 item g (the unpacked kernel)"),
    "warm_mu": (None, "queue 2 item b (warm continuation)"),
    "warm_nu": (None, "queue 2 item b (warm continuation)"),
    "warm_count": (None, "queue 2 item b (warm continuation)"),
    "warm_pgrads": (False, "queue 2 item b (warm_pgrads, the training slice)"),
    "emit_warm_opt_state": (False, "queue 2 item b (emit_warm_opt_state)"),
}

_LOSS_CODES = {"none": 0, "bernoulli": 1, "gaussian": 2}


@dataclasses.dataclass(frozen=True)
class _Chain:
    """Validated arguments of one chain call."""

    dims: tp.Tuple[int, int, int, int]
    T: int
    lr: float
    noise_std: float
    loss: str
    inv_var: float
    warm_T: int
    warm_lr: float
    warm_b1: float
    warm_b2: float
    warm_eps: float
    return_scalars: bool
    tile: int
    seed: int


def _chain_args(params, latents, target, seed, *, T: int, lr: float,
                noise_var: tp.Optional[float] = 2.0, loss: str = "bernoulli",
                input_var: float = 1.0,
                mixing: int = 0,  # read only with parameter gradients
                warm_T: int = 0, warm_lr: float = 0.1, warm_b1: float = 0.9,
                warm_b2: float = 0.999, warm_eps: float = 1e-8,
                activation: str = "relu", return_scalars: bool = False,
                batch_tile: tp.Optional[int] = None, **unported) -> _Chain:
    for name, value in unported.items():
        if name not in _UNPORTED:
            raise TypeError(f"mcpc_chain got an unexpected keyword {name!r}")
        off, item = _UNPORTED[name]
        if (value is not None) if off is None else (value != off):
            raise NotImplementedError(
                f"mcpc_chain({name}={value!r}) is not ported yet: ROADMAP.md {item}"
            )
    if loss in ("bernoulli_mask", "gaussian_mask"):
        raise NotImplementedError(
            f"mcpc_chain(loss={loss!r}) is not ported yet: ROADMAP.md "
            f"{_UNPORTED['mask_perc'][1]}"
        )
    if loss not in _LOSS_CODES:
        raise ValueError(f"unknown loss {loss!r}")
    if activation == "tanh":
        raise NotImplementedError(
            "mcpc_chain(activation='tanh') is not ported yet: ROADMAP.md "
            "queue 2 item e (tanh)"
        )
    if activation != "relu":
        raise ValueError(f"unsupported activation {activation!r}")
    if len(params) != 4 or len(latents) != 3:
        raise ValueError("mcpc_chain needs 4 Linear params and 3 latents")
    x0, x1, x2 = latents
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
    if T < 0 or warm_T < 0:
        raise ValueError("T and warm_T must be >= 0")

    tile = _pick_batch_tile(B) if batch_tile is None else int(batch_tile)
    if B % tile != 0:
        raise ValueError(f"batch {B} not divisible by batch_tile {tile}")
    if batch_tile is None and B > tile and tile < 128:
        raise ValueError(
            f"batch {B} has no tile divisor >= 128 (best: {tile}); pad the "
            "batch to a multiple of 128 or pass batch_tile explicitly"
        )
    seed = int(seed)
    return _Chain(
        dims=dims, T=int(T), lr=float(lr),
        # the JAX wrapper takes this square root in double
        noise_std=float(np.sqrt(lr * noise_var)) if noise_var else 0.0,
        loss=loss, inv_var=1.0 / input_var, warm_T=int(warm_T),
        warm_lr=float(warm_lr), warm_b1=float(warm_b1),
        warm_b2=float(warm_b2), warm_eps=float(warm_eps),
        return_scalars=bool(return_scalars), tile=tile,
        # the JAX wrapper passes the seed as int32
        seed=((seed + 2**31) % 2**32) - 2**31,
    )


def _result(latents, scalars, return_scalars: bool):
    return (latents, None, scalars) if return_scalars else (latents, None)


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


@torch.no_grad()
def _reference(c: _Chain, params, latents, target):
    d0, d1, d2, D = c.dims
    b0 = params[0]["b"]
    (w1, b1), (w2, b2), (w3, b3) = ((params[i]["w"], params[i]["b"])
                                    for i in (1, 2, 3))
    X = torch.cat(latents, dim=1)
    B = X.shape[0]
    y = target if target is not None else torch.zeros(
        (B, D), dtype=X.dtype, device=X.device)

    def grads(X, want_scalars: bool):
        x0, x1, x2 = X.split((d0, d1, d2), dim=1)
        h0, h1, h2 = torch.relu(x0), torch.relu(x1), torch.relu(x2)
        err0 = x0 - b0
        e1 = x1 - (h0 @ w1 + b1)
        e2 = x2 - (h1 @ w2 + b2)
        if c.loss == "none":
            S = None
            back2 = torch.zeros_like(x2)
        else:
            logits = h2 @ w3 + b3
            if c.loss == "bernoulli":
                S = (0.5 + 0.5 * torch.tanh(0.5 * logits)) - y
            else:
                S = (logits - y) * c.inv_var
            back2 = (-S) @ w3.T
        back = torch.cat([e1 @ w1.T, e2 @ w2.T, back2], dim=1)
        dH = (X > 0).to(X.dtype)
        G = torch.cat([err0, e1, e2], dim=1) - dH * back
        if not want_scalars:
            return G, None
        energy = 0.5 * (torch.sum(err0 * err0) + torch.sum(e1 * e1)
                        + torch.sum(e2 * e2))
        if c.loss == "bernoulli":
            loss_s = torch.sum(
                torch.clamp(logits, min=0.0) - logits * y
                + torch.log1p(torch.exp(-torch.abs(logits)))
            )
        elif c.loss == "gaussian":
            loss_s = torch.sum(0.5 * c.inv_var * (logits - y) ** 2)
        else:
            loss_s = torch.zeros((), dtype=X.dtype, device=X.device)
        return G, {"loss": loss_s.reshape(1), "energy": energy.reshape(1)}

    scalars = None
    if c.warm_T > 0:
        m = torch.zeros_like(X)
        v = torch.zeros_like(X)
        # bias-correction powers carried step to step in f32, as the kernel
        b1p, b2p = np.float32(c.warm_b1), np.float32(c.warm_b2)
        for s in range(c.warm_T):
            last = c.return_scalars and c.T == 0 and s == c.warm_T - 1
            G, sc = grads(X, last)
            scalars = sc if last else scalars
            c1 = float(np.float32(1.0) - b1p)
            c2 = float(np.float32(1.0) - b2p)
            m = c.warm_b1 * m + (1.0 - c.warm_b1) * G
            v = c.warm_b2 * v + (1.0 - c.warm_b2) * G * G
            # optax's operation order: (m / c1) / (sqrt(v / c2) + eps)
            X = X - c.warm_lr * (m / c1) / (torch.sqrt(v / c2) + c.warm_eps)
            b1p = np.float32(b1p * np.float32(c.warm_b1))
            b2p = np.float32(b2p * np.float32(c.warm_b2))

    if c.noise_std > 0.0 and c.T > 0:
        idx, seeds = _noise_index(c, B, X.device)
    z_cos = z_sin = None
    for t in range(c.T):
        if c.noise_std > 0.0 and t % 2 == 0:
            p = t // 2
            z_cos, z_sin = box_muller(
                counter_bits_at(idx, seeds, 2 * p),
                counter_bits_at(idx, seeds, 2 * p + 1),
            )
        last = c.return_scalars and t == c.T - 1
        G, sc = grads(X, last)
        scalars = sc if last else scalars
        X = X - c.lr * G
        if c.noise_std > 0.0:
            X = X + c.noise_std * (z_cos if t % 2 == 0 else z_sin)

    if c.return_scalars and scalars is None:  # no steps at all
        zero = torch.zeros(1, dtype=X.dtype, device=X.device)
        scalars = {"loss": zero, "energy": zero.clone()}
    new = tuple(x.contiguous() for x in X.split((d0, d1, d2), dim=1))
    return _result(new, scalars, c.return_scalars)


def mcpc_chain_reference(params, latents, target, seed, **options):
    """Plain PyTorch version of :func:`mcpc_chain`: the same arguments, the
    same arithmetic, on any device.  The tests and ``chip_smoke.py`` hold the
    kernel against it."""
    return _reference(_chain_args(params, latents, target, seed, **options),
                      params, latents, target)


# --------------------------------------------------------------- kernel

_KERNEL_ROWS = (16, 8, 4, 2, 1)
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its C signatures."""
    from . import _build

    lib = _build.load("mcpc_chain")
    lib.mcpc_chain_launch.restype = _I
    lib.mcpc_chain_launch.argtypes = (
        [_P] * 18 + [_I] * 10 + [_F] * 9 + [_I, _I, _P]
    )
    lib.mcpc_chain_smem_bytes.restype = ctypes.c_size_t
    lib.mcpc_chain_smem_bytes.argtypes = [_I] * 6
    lib.mcpc_chain_smem_budget.restype = _I
    lib.mcpc_chain_smem_budget.argtypes = [_I, _I]
    lib.mcpc_chain_error_string.restype = ctypes.c_char_p
    lib.mcpc_chain_error_string.argtypes = [_I]
    return lib


def kernel_rows(dims, warm: bool, device) -> int:
    """Rows per block: the largest of 16, 8, 4, 2, 1 whose shared memory
    fits one block on ``device``."""
    lib = _library()
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    d0, d1, d2, D = dims
    for rows in _KERNEL_ROWS:
        need = lib.mcpc_chain_smem_bytes(d0, d1, d2, D, rows, int(warm))
        budget = lib.mcpc_chain_smem_budget(index, rows)
        if budget < 0:
            raise RuntimeError("could not query the device's shared memory")
        if need <= budget:
            return rows
    raise ValueError(f"dims {dims} need more shared memory than one block has")


def _kernel(c: _Chain, params, latents, target):
    d0, d1, d2, D = c.dims
    device = latents[0].device
    tensors = list(latents) + [t for p in params for t in p.values()]
    if target is not None:
        tensors.append(target)
    for t in tensors:
        if t.device != device:
            raise ValueError("mcpc_chain: all tensors must be on one device")
        if t.dtype != torch.float32:
            raise TypeError(f"mcpc_chain takes float32 tensors, got {t.dtype}")
    B = latents[0].shape[0]
    x0, x1, x2 = (x.contiguous() for x in latents)
    b0, b1, b2, b3 = (p["b"].contiguous() for p in params)
    w1, w2, w3 = (params[i]["w"].contiguous() for i in (1, 2, 3))
    # transposed copies staged once per call, so the backward products
    # read coalesced
    w1t, w2t, w3t = (w.t().contiguous() for w in (w1, w2, w3))
    y = (target.contiguous() if target is not None
         else torch.zeros((B, D), dtype=torch.float32, device=device))
    outs = [torch.empty_like(x) for x in (x0, x1, x2)]
    rows = kernel_rows(c.dims, c.warm_T > 0, device)
    scal = torch.zeros((-(-B // rows), 2), dtype=torch.float64, device=device)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.mcpc_chain_launch(
            x0.data_ptr(), x1.data_ptr(), x2.data_ptr(),
            outs[0].data_ptr(), outs[1].data_ptr(), outs[2].data_ptr(),
            y.data_ptr(),
            b0.data_ptr(), b1.data_ptr(), b2.data_ptr(), b3.data_ptr(),
            w1.data_ptr(), w2.data_ptr(), w3.data_ptr(),
            w1t.data_ptr(), w2t.data_ptr(), w3t.data_ptr(),
            scal.data_ptr(),
            B, d0, d1, d2, D,
            c.T, c.warm_T, _LOSS_CODES[c.loss], int(c.return_scalars), rows,
            c.inv_var, c.lr, c.noise_std,
            c.warm_lr, c.warm_b1, c.warm_b2,
            1.0 - c.warm_b1, 1.0 - c.warm_b2, c.warm_eps,
            c.seed, c.tile, stream,
        )
    if err != 0:
        msg = lib.mcpc_chain_error_string(err).decode()
        raise RuntimeError(f"mcpc_chain kernel launch failed: {msg} ({err})")
    mcpc_chain.launches += 1
    scalars = None
    if c.return_scalars:
        sums = scal.sum(dim=0).to(torch.float32)
        scalars = {"loss": sums[0:1], "energy": sums[1:2]}
    return _result(tuple(outs), scalars, c.return_scalars)


def mcpc_chain(params, latents, target, seed, **options):
    """Run (optionally) ``warm_T`` Adam MAP steps, then ``T`` Langevin steps.

    Args:
        params: 4 ``{"w": [in, out], "b": [out]}`` dicts (the canonical MLP;
            ``params[0]["w"]`` is unused, its input being zeros).
        latents: ``(x0, x1, x2)``, each ``[B, d_l]`` float32.
        target: ``[B, D]`` float32, or None for zeros.
        seed: int (or 0-d tensor) keying the noise stream.

    Keyword options, as ``mcpc_chain_pallas``: ``T``, ``lr``,
    ``noise_var=2.0`` (None or 0: no noise), ``loss`` in ``"bernoulli"``,
    ``"gaussian"``, ``"none"``, ``input_var=1.0``, ``mixing`` (used only
    with parameter gradients), ``warm_T=0``, ``warm_lr=0.1``,
    ``warm_b1=0.9``, ``warm_b2=0.999``, ``warm_eps=1e-8``,
    ``activation="relu"``, ``return_scalars=False``, ``batch_tile=None``
    (keys the per-tile noise seeds).  The options that are not ported yet
    raise ``NotImplementedError`` naming their ROADMAP.md item.

    Returns ``(latents', None)``, or ``(latents', None, scalars)`` with
    ``return_scalars``: ``{"loss": [1], "energy": [1]}``, the batch sums
    before the final step's update.

    CPU tensors run :func:`mcpc_chain_reference`; CUDA tensors launch the
    kernel or raise.  ``mcpc_chain.launches`` counts kernel launches.
    """
    c = _chain_args(params, latents, target, seed, **options)
    device = latents[0].device
    if device.type == "cpu":
        return _reference(c, params, latents, target)
    if device.type == "cuda":
        return _kernel(c, params, latents, target)
    raise ValueError(f"mcpc_chain runs on cpu or cuda, not {device.type}")


mcpc_chain.launches = 0
