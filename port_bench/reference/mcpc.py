"""The plain MCPC arithmetic the benchmark holds the port to.

Plain PyTorch, in any dtype and on any device, written from the model's
equations and importing nothing of the program.  The generative MLP

    zeros -> Linear(d0,d0) -> PC(x0) -> relu -> Linear(d0,d1) -> PC(x1)
          -> relu -> Linear(d1,d2) -> PC(x2) -> relu -> Linear(d2,D) -> Bernoulli

has the energy gradient of the latents X = [x0 | x1 | x2]

    err0 = x0 - b0;  e1 = x1 - (relu(x0) W1 + b1);  e2 = x2 - (relu(x1) W2 + b2)
    S    = (sigmoid(relu(x2) W3 + b3) - y) * clamped
    G    = [err0 | e1 | e2] - relu'(X) * [e1 W1^T | e2 W2^T | -S W3^T]

An Adam MAP step (optax's order) or a Langevin step ``X - lr G + sqrt(lr
var) z`` moves the latents; a sampling step adds the Hebbian sums

    gW1 += -relu(x0)^T e1   gW2 += -relu(x1)^T e2   gW3 += relu(x2)^T S
    gb0 += sum -err0        gb1 += sum -e1          gb2 += sum -e2    gb3 += sum S

from the state before its update.  The Langevin noise is the stateless
counter hash the model's training recipe defines (two murmur3 finaliser
rounds over seed, draw and element index; Box-Muller over the exponent-bit
uniforms), indexed over the 128-padded packed latent layout: an element of
row r, column c of latent l reads index ``(r mod tile) * XW + off_l + c`` of
the stream keyed ``seed + r div tile``, step pair p reads draws 2p and
2p+1, the even step takes r cos, the odd one r sin.  Here the uniforms, the
logarithm, the root and the angle are taken in the working dtype with the
library's own functions.

``mm`` is the matrix product (``torch.matmul`` by default); the benchmark's
control passes a lower-precision one.
"""

from __future__ import annotations

import math
import typing as tp

import torch

Tensor = torch.Tensor
M32 = 0xFFFFFFFF
TILE_CAP = 1024


# -- the noise stream ------------------------------------------------------------


def _mul32(x: Tensor, c: int) -> Tensor:
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def _fmix32(x: Tensor) -> Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def counter_bits(idx: Tensor, seed, draw) -> Tensor:
    """uint32 draws (held in int64) of the stream keyed ``seed`` at element
    indices ``idx``; ``seed`` and ``draw`` broadcast against ``idx``."""
    h = (_mul32(seed & M32, 0x9E3779B1) + _mul32(draw & M32, 0x6C62272E)) & M32
    return _fmix32(_fmix32((h + idx) & M32) ^ 0xA511E9B3)


def normals(bits1: Tensor, bits2: Tensor, dtype) -> tp.Tuple[Tensor, Tensor]:
    """Box-Muller (r cos, r sin) from the uniforms u1 = 1 - m1 / 2^23 in (0,
    1] and u2 = m2 / 2^23 in [0, 1), m the top 23 bits of a draw."""
    scale = 2.0 ** -23
    u1 = 1.0 - (bits1 >> 9).to(dtype) * scale
    u2 = (bits2 >> 9).to(dtype) * scale
    r = torch.sqrt(-2.0 * torch.log(u1))
    angle = (2.0 * math.pi) * u2
    return r * torch.cos(angle), r * torch.sin(angle)


def batch_tile(B: int) -> int:
    """The largest divisor of B that is at most 1024: the rows one noise
    stream covers."""
    return next(t for t in range(min(B, TILE_CAP), 0, -1) if B % t == 0)


def wrap_int32(seed: int) -> int:
    return ((int(seed) + 2 ** 31) % 2 ** 32) - 2 ** 31


def noise_index(dims, B: int, seed: int, device) -> tp.Tuple[Tensor, Tensor]:
    """(element index [B, N], stream key [B, 1]) of every latent element."""
    cols, off = [], 0
    for d in dims[:3]:
        cols.append(torch.arange(d, dtype=torch.int64, device=device) + off)
        off += -(-d // 128) * 128
    rows = torch.arange(B, dtype=torch.int64, device=device)
    tile = batch_tile(B)
    idx = (rows % tile)[:, None] * off + torch.cat(cols)[None, :]
    return idx, (wrap_int32(seed) + rows // tile)[:, None]


def step_noise(idx: Tensor, keys: Tensor, t: Tensor, dtype) -> Tensor:
    """The normals of steps ``t`` (an int64 tensor that broadcasts against
    ``idx`` on the left, e.g. [K, 1, 1] for K chains at once)."""
    p = t // 2
    z_cos, z_sin = normals(counter_bits(idx, keys, 2 * p),
                           counter_bits(idx, keys, 2 * p + 1), dtype)
    return torch.where(t % 2 == 0, z_cos, z_sin)


# -- the model -------------------------------------------------------------------


def init_params(dims, u: Tensor) -> tp.List[dict]:
    """The four Linear layers ``{"w": [in, out], "b": [out]}`` from uniforms
    ``u`` in [0, 1) (one flat tensor, consumed in layer order, w then b),
    each uniform in +-1/sqrt(in)."""
    d0, d1, d2, D = dims
    shapes = [((d0, d0), (d0,)), ((d0, d1), (d1,)), ((d1, d2), (d2,)), ((d2, D), (D,))]
    params, at = [], 0
    for (wi, wo), (bo,) in shapes:
        bound = 1.0 / math.sqrt(wi)
        w = u[at : at + wi * wo].reshape(wi, wo)
        at += wi * wo
        b = u[at : at + bo]
        at += bo
        params.append({"w": -bound + 2.0 * bound * w, "b": -bound + 2.0 * bound * b})
    return params


def n_params(dims) -> int:
    d0, d1, d2, D = dims
    return d0 * d0 + d0 + d0 * d1 + d1 + d1 * d2 + d2 + d2 * D + D


class Chain:
    """One chain call's fixed inputs: ``params`` (converted to ``dtype``),
    the target ``y``, the clamped output columns (``mask_lo``: columns at or
    above it carry the loss; 0 clamps all), and the product ``mm``."""

    def __init__(self, params, y: Tensor, dtype=torch.float64, mask_lo: int = 0,
                 mm=torch.matmul):
        self.dtype = dtype
        self.mm = mm
        self.b0 = params[0]["b"].to(dtype)
        (self.w1, self.b1), (self.w2, self.b2), (self.w3, self.b3) = (
            (params[i]["w"].to(dtype), params[i]["b"].to(dtype)) for i in (1, 2, 3))
        self.dims = (self.b0.shape[0], self.b1.shape[0], self.b2.shape[0], self.b3.shape[0])
        self.y = y.to(dtype)
        D = self.dims[3]
        self.clamped = None
        if mask_lo:
            self.clamped = (torch.arange(D, device=y.device) >= mask_lo).to(dtype)

    def split(self, X: Tensor):
        d0, d1, _, _ = self.dims
        return X[..., :d0], X[..., d0 : d0 + d1], X[..., d0 + d1 :]

    def terms(self, X: Tensor):
        """(G, relu(X) by layer, err0, e1, e2, S) at latents ``X`` [..., N]."""
        mm = self.mm
        x0, x1, x2 = self.split(X)
        h0, h1, h2 = torch.relu(x0), torch.relu(x1), torch.relu(x2)
        err0 = x0 - self.b0
        e1 = x1 - (mm(h0, self.w1) + self.b1)
        e2 = x2 - (mm(h1, self.w2) + self.b2)
        S = torch.sigmoid(mm(h2, self.w3) + self.b3) - self.y
        if self.clamped is not None:
            S = S * self.clamped
        back = torch.cat([mm(e1, self.w1.T), mm(e2, self.w2.T), -mm(S, self.w3.T)], dim=-1)
        G = torch.cat([err0, e1, e2], dim=-1) - (X > 0).to(X.dtype) * back
        return G, (h0, h1, h2), err0, e1, e2, S

    def decode(self, x2: Tensor) -> Tensor:
        """The logits of the deepest latent."""
        return self.mm(torch.relu(x2.to(self.dtype)), self.w3) + self.b3


def f32(x: float) -> float:
    """``x`` rounded to float32."""
    return float(torch.tensor(x, dtype=torch.float32))


def adam_constants(b1: float, b2: float, steps: int):
    """Adam's constants as the recipe's float32 arithmetic holds them: the
    moments' weights ``b`` and ``1 - b`` each rounded to float32, and the
    bias corrections ``1 - b^k`` of steps k = 1..``steps`` from powers
    carried step to step in float32.  Returns ((b1, 1-b1, b2, 1-b2), [(c1,
    c2), ...])."""
    w = (f32(b1), f32(1.0 - b1), f32(b2), f32(1.0 - b2))
    p1 = torch.tensor(b1, dtype=torch.float32)
    p2 = torch.tensor(b2, dtype=torch.float32)
    fb1, fb2 = p1.clone(), p2.clone()
    cs = []
    for _ in range(steps):
        cs.append((float(1.0 - p1), float(1.0 - p2)))
        p1, p2 = p1 * fb1, p2 * fb2
    return w, cs


def adam_warm(chain: Chain, X: Tensor, steps: int, lr: float, b1: float = 0.9,
              b2: float = 0.999, eps: float = 1e-8):
    """``steps`` Adam MAP steps on the latents from zero moments (optax's
    order, :func:`adam_constants`): (X, m, v)."""
    (w1, w1c, w2, w2c), cs = adam_constants(b1, b2, steps)
    m = torch.zeros_like(X)
    v = torch.zeros_like(X)
    for c1, c2 in cs:
        G = chain.terms(X)[0]
        m = w1 * m + w1c * G
        v = w2 * v + w2c * G * G
        X = X - lr * (m / c1) / (torch.sqrt(v / c2) + eps)
    return X, m, v


def langevin(chain: Chain, X: Tensor, steps: int, lr: float, noise_var: float, seed: int,
             t0=0, grads_from: tp.Optional[int] = None, capture_stride: int = 0):
    """``steps`` Langevin steps from latents ``X`` ([B, N], or [K, B, N] for K
    chains at once, each starting at its own step ``t0``: an int or an int64
    tensor [K]).  With ``grads_from`` the Hebbian sums over steps ``t >=
    grads_from`` come back too; with ``capture_stride`` the pre-update
    latents of every ``capture_stride``-th step.  Returns (X, sums or None,
    captures [n, ..., N] or None)."""
    B = X.shape[-2]
    idx, keys = noise_index(chain.dims, B, seed, X.device)
    std = math.sqrt(lr * noise_var)
    t0 = torch.as_tensor(t0, dtype=torch.int64, device=X.device).reshape(-1, *([1] * 2))
    if X.dim() == 2:
        t0 = t0.reshape(1, 1)
    sums = None
    if grads_from is not None:
        d0, d1, d2, D = chain.dims
        sums = [torch.zeros(s, dtype=X.dtype, device=X.device)
                for s in ((d0, d1), (d1, d2), (d2, D), (d0,), (d1,), (d2,), (D,))]
    caps = []
    for j in range(steps):
        if capture_stride and j % capture_stride == 0:
            caps.append(X.clone())
        G, (h0, h1, h2), err0, e1, e2, S = chain.terms(X)
        if sums is not None and j >= grads_from:
            mm = chain.mm
            sums[0] -= mm(h0.T, e1)
            sums[1] -= mm(h1.T, e2)
            sums[2] += mm(h2.T, S)
            sums[3] -= err0.sum(0)
            sums[4] -= e1.sum(0)
            sums[5] -= e2.sum(0)
            sums[6] += S.sum(0)
        z = step_noise(idx, keys, t0 + j, X.dtype)
        X = X - lr * G + std * z
    return X, sums, (torch.stack(caps) if caps else None)


def pgrads_tree(sums, dims) -> tp.List[dict]:
    """The sums as the parameters' tree; the first layer's weight, which a
    zero input never moves, is zero."""
    d0 = dims[0]
    z = sums[0].new_zeros((d0, d0))
    return [{"w": z, "b": sums[3]}, {"w": sums[0], "b": sums[4]},
            {"w": sums[1], "b": sums[5]}, {"w": sums[2], "b": sums[6]}]


def adam_params(params, state, grads, lr: float, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8):
    """optax's Adam on the parameters' tree: (params', (count, mu, nu))."""
    count, mu, nu = state
    count += 1
    new_p, new_mu, new_nu = [], [], []
    for p, m, v, g in zip(params, mu, nu, grads):
        lp, lm, lv = {}, {}, {}
        for k in p:
            lm[k] = b1 * m[k] + (1.0 - b1) * g[k]
            lv[k] = b2 * v[k] + (1.0 - b2) * g[k] * g[k]
            step = (lm[k] / (1.0 - b1 ** count)) / (torch.sqrt(lv[k] / (1.0 - b2 ** count)) + eps)
            lp[k] = p[k] - lr * step
        new_p.append(lp)
        new_mu.append(lm)
        new_nu.append(lv)
    return new_p, (count, new_mu, new_nu)


def adam_init(params):
    zeros = [{k: torch.zeros_like(v) for k, v in p.items()} for p in params]
    return 0, zeros, [{k: torch.zeros_like(v) for k, v in p.items()} for p in params]
