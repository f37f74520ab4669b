"""The step rule: every step of an f32 MCPC chain held, from the chain's own
state, to a rounding bound derived for that step.

    cap = step_rule.capture(run, (params, latents, target, seed), kw, original=parts)
    verdict = step_rule.hold(cap, (params, latents, target, seed), kw, sincos_err=e)
    print(step_rule.verdict_text(verdict)); ok = verdict["ok"]

``run`` is the chain under test, called as ``mcpc_chain`` is (the kernel's
wrapper on CUDA tensors, or on the CPU the plain version, a faulty copy of
it, or the JAX package's chain behind an adapter); ``kw`` the held call's
options; ``original`` the held call's parts (``parts_of``), or None to make
the call here.  ``chip_smoke.py`` decides its f32 holds by it, and
``tests/test_torch_step_rule.py`` holds correct orders and faults by it on
the CPU.  It imports the port and never JAX.

What it does.  A chain is thousands of steps, each a function of the state
before it, and two correct f32 orders part wherever a step amplifies
rounding (relu's kink, an Adam step on a gradient near 0).  So the rule
never compares trajectories: it takes every state the chain passed through
and holds each step from that state, where nothing has been amplified yet.

1. ``capture`` launches the held call again with ``capture_stride=1`` and
   checks that it ends with the call's latents, gradients, scalars and
   Adam moments bit for bit (and, where the call captured, with its
   trajectory).  A call with a warm and a Langevin phase captures only its
   Langevin phase, so it is split into a warm-only call (``T=0``,
   ``capture_stride=1``, ``emit_warm_opt_state=True``) and a Langevin-only
   call from that call's end (its draws are indexed by the phase's own
   step, so the split is the same chain); where the split does not end
   with the call's bits the hold fails on that bit check, and the call's
   own end state and gradients are held from the split's last captured
   state.
   A chain that cannot capture (``packed=False``) is captured by prefixes:
   the state after ``t`` steps is the end of the same call with ``T=t``.
2. ``hold`` runs the plain version's step (``ops/mcpc_chain.py``'s
   ``step_terms``, ``langevin_update``, ``adam_moments`` and
   ``adam_step``, shared with the plain version) in float64 on every
   captured state at once, in chunks of about ``CHUNK_ROWS`` rows, with the
   chain's own float32 constants, and holds every element of every next
   state, of the gradient sums, of the scalars and of the Adam moments to
   its bound below.  A part holds when every element lies within its
   bound and is finite.  For each part it reports the largest ratio of
   the distance from the float64 value to the bound on that side (1 is
   the bound), with its step and row.

The bound (derived here, fitted to no run).  u = 2^-24 is float32's unit
roundoff; ``u`` of ``hold`` is that of the products (2^-24 for the f32
FMA builds; a split-TF32 or other product route passes its own), and a
product sum takes the larger of the two.  For a sum of n terms, each a
value or a product, taken in any order, with or without fused
multiply-adds, |computed - exact| <= gamma_n * sum |term|, gamma_n =
n u / (1 - n u) (Higham, Accuracy and Stability of Numerical Algorithms,
(3.5)): each term meets at most n roundings.  An elementwise operation
rounds once (u |result|); one ulp of a normal float32 v is at most
2^-23 |v|; below the normal range a rounding may give a subnormal or
flush to zero, at most 2^-126 (``UNDERFLOW``) off, which the bounds of the
updates and of Adam's moments add for each rounding (a moment that decays
for thousands of steps sticks at the smallest subnormal in float32).
The library functions take the CUDA C Programming Guide's
largest errors for single precision (``LIB_ULPS``: tanhf 2, logf 1, expf
2, log1pf 1 ulp; sqrtf and division correctly rounded; the kernels are
built without ``--use_fast_math``).  The step's inputs are exact: the
captured latents, the float32 parameters, target and constants.

With h = act(x) (relu exact; tanh within kh |h|, kh = 2 * 2 * 2^-23) and
|W| taken elementwise, per element and step:

  err0 = x0 - b0                 B_err0 = u |err0|
  e_l  = x_l - (h W_l + b_l)     B_e = g(d+2) (|x_l| + |h| |W_l| + |b_l|) + kh |h| |W_l|
  lg   = h2 W3 + b3              B_lg = g(d2+1) (|h2| |W3| + |b3|) + kh |h2| |W3|
  S, Bernoulli: 0.5 + 0.5 tanh(0.5 lg) - y
                                 B_S = B_lg / 4 (the sigmoid's slope is at most 1/4)
                                       + 2 u |t| (tanhf's 2 ulp of t, halved) + u (|sig| + |S|)
  S, Gaussian or output PC: (lg - y) / var
                                 B_S = (B_lg + u |lg - y|) / var + u |S|;  0 where masked
  back_l = e_{l+1} W_{l+1}^T     B_back = (g(d_{l+1}) |e_{l+1}| + B_e) |W_{l+1}|^T
                                 (back_2 = -S W3^T with B_S, g(D))
  act'   relu: exact at the captured x;  tanh: 1 - h^2,
                                 B_act' = 2 |h| kh |h| + u (h^2 + |act'|)
  G = [err0|e1|e2] - act' back   B_G = B_E + |act'| B_back + |back| B_act'
                                       + g(2) (|E| + |act' back|)
  (the output-PC site's x3 takes G3 = -S, B_G3 = B_S.)

Langevin step, x' = x - lr G + s z (s = sqrt(lr var)):

  z = sqrt(-2 log u1) * cos or sin(2 pi u2) from exact uniforms (the
  counter hash's bits, u1 = 2 - f1 and u2 = f2 - 1 are exact), r =
  sqrt(-2 log u1): logf's 1 ulp moves r by at most u r, sqrtf's rounding
  by u r, ``sincos_2pi`` by at most its largest error e over all 2^23
  inputs it can take (measured: ``sincos_error``; the one constant the
  rule measures), the product rounds once:
                                 B_z = (LIB_ULPS["log"] + 2) u |z| + r e
  B_x' = lr B_G + s B_z + g(3) (|x| + lr |G| + s |z|) + UPDATE_ULPS 2 u max(|x|, |x'|)

g(3): the update's terms meet at most three roundings (x - lr G, then +
s z, each product rounded or fused).  UPDATE_ULPS (1) lets the stored
latent carry one ulp more, of the state read or the state written: a
correct order may round the update once more than the plain version does
(the witnesses of ``chip_smoke.jittered_rounding(keyed=True)``, which move
every update's result by up to an ulp, are such orders).

Adam (warm) step, optax's order, the bias powers carried in float32 as
the kernel carries them (``bias_corrections``):
  m' = b1 m + (1-b1) g, v' = b2 v + (1-b2) g^2,
  x' = x - lr (m'/c1) / (sqrt(v'/c2) + eps).
The moments are not captured: the rule carries an interval for each of
m and v along the chain's own states, from g's interval [G - B_G, G + B_G]
and the roundings of the averages (g(2) of m's terms, g(3) of v's); the
intervals contract (b1, b2 < 1).  The step is monotone in m and in v, so
its range over the m-v box is taken at the box's corners; its own six
operations round it by at most g(6) of itself, the subtraction by u |x'|,
and UPDATE_ULPS as above.  The next state must lie in that interval; the
ratio is its distance from the step the float64 gradients give (the
moments' float64 values, which lie in their intervals) over that value's
distance from the interval's end on the same side.
Where a gradient lies within its bound of 0, Adam's first steps take
either sign and the interval is as wide as the step: that is the only
slack the rule has, and it is arithmetic.  Moments a call hands out are
held to the intervals.  The parameters' Adam step after a training batch
(``param_hold``) is held the same way from the chain's own gradients.

Gradient sums (Langevin steps t >= mixing, and the last warm step with
``warm_pgrads``), over n = B * steps terms (rows, steps and clusters,
whatever the order): gW_l = -sum h_{l-1}^T e_l has the bound |h|^T (B_e +
(g(n) + kh) |e|), gb_l = -sum e_l the bound sum (B_e + g(n) |e|), and gW3,
gb3 the same with S.  Scalars (loss and energy of a step, summed over the
batch and the columns in float32 or better): energy 0.5 sum e^2 within
0.5 sum (2 |e| B_e + B_e^2) + g(n+2) 0.5 sum e^2; the Bernoulli loss
element max(l, 0) - l y + log1p(exp(-|l|)) within |sig(l) - y| B_lg +
g(4) (max(l, 0) + |l y| + c) + 2 u (LIB_ULPS exp + log1p) c, c the log1p
term; the Gaussian one within |l - y| B_lg / var + g(3) of itself; each
sum within g(n) of the sum of its elements' magnitudes.

First order.  Each bound is propagated to first order: a product of two
errors is dropped.  Each dropped term is at most gmax times a kept one,
gmax the largest relative bound of the step (g of its longest sum), and a
bound passes through at most LEVELS (8) such products on its way from the
products to the update, so every bound is multiplied by (1 + gmax)^LEVELS.
A gradient sum of n terms takes its own (1 + g(n))^2 on top: one for the
sum, one for the products of its terms.  The float64 evaluation's own error,
2^-53 relative, is 2^-29 of the float32 terms it stands beside and lies
within that factor too.  No constant of the rule is set from a run but
the ``sincos_2pi`` error, which is measured over its whole input domain.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
import time
import typing as tp

import numpy as np
import torch

chain = importlib.import_module("montecarlopredictivecoding_tpu_torch.ops.mcpc_chain")
Tensor = torch.Tensor

U32 = 2.0 ** -24
# the CUDA C Programming Guide's largest errors of the single-precision
# functions the chain calls, in ulps
LIB_ULPS = {"tanh": 2, "log": 1, "exp": 2, "log1p": 1}
# ulps the stored latent may carry beyond its update's roundings
UPDATE_ULPS = 1
# how far a rounding can err below float32's normal range: to a subnormal,
# or flushed to zero
UNDERFLOW = 2.0 ** -126
# how many first-order products a bound passes through (see the docstring)
LEVELS = 8
CHUNK_ROWS = 1 << 16

# the options that capture() sets for its own calls
_OWN_OPTIONS = ("capture_stride", "scalar_stride", "emit_warm_opt_state", "return_scalars",
                "warm_mu", "warm_nu", "warm_count", "warm_pgrads", "with_pgrads")


def gamma(n: int, u: float = U32) -> float:
    """Higham's gamma_n = n u / (1 - n u): the relative bound of a sum of
    n terms taken in any order."""
    if n * u >= 0.5:
        raise ValueError(f"a sum of {n} terms at u = {u} is beyond the rule's bound")
    return n * u / (1.0 - n * u)


def f32(x: float) -> float:
    return float(np.float32(x))


def parts_of(out, kw) -> dict:
    """The named parts of a chain's result: latents, pgrads and, with their
    options, the trajectory (and the output-PC site's), the scalars and the
    Adam moments."""
    parts, rest = {"latents": out[0], "pgrads": out[1]}, list(out[2:])
    out_pc = kw.get("output_var") is not None
    for name, on in (("traj", kw.get("capture_stride")),
                     ("traj3", kw.get("capture_stride") and out_pc),
                     ("scalars", kw.get("return_scalars")),
                     ("moments", kw.get("emit_warm_opt_state"))):
        if on:
            parts[name] = rest.pop(0)
    return parts


def bits_equal(a, b) -> bool:
    """Two results' parts (tensors, or tuples, lists and dicts of them, or
    None) hold the same bits."""
    if isinstance(a, dict):
        return set(a) == set(b) and all(bits_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(bits_equal(x, y) for x, y in zip(a, b))
    if a is None or b is None:
        return a is b
    return a.shape == b.shape and torch.equal(a, b)


def sincos_error(fn, device="cpu") -> float:
    """The largest error of ``fn(u) -> (cos 2 pi u, sin 2 pi u)`` over all
    2^23 inputs the noise can give it (u = k 2^-23, k < 2^23, exact in
    float32), against float64."""
    k = torch.arange(2 ** 23, dtype=torch.float64, device=device)
    u = k / 2 ** 23
    c, s = fn(u.float())
    angle = (2.0 * math.pi) * u
    return max(float((c.double() - torch.cos(angle)).abs().max()),
               float((s.double() - torch.sin(angle)).abs().max()))


# ----------------------------------------------------------------- capture


@dataclasses.dataclass
class Phase:
    """One phase of a captured chain: its steps' pre-update latents."""

    kind: str                   # "warm" (Adam) or "langevin"
    traj: Tensor                # [steps, B, W]
    cols: tp.Optional[Tensor]   # the columns of W that hold the latents; None: all
    traj3: tp.Optional[Tensor]  # [steps, B, >= D] the output-PC site's x3, or None
    parts: dict                 # the phase's call: its end latents, pgrads, moments, scalars

    @property
    def steps(self) -> int:
        return self.traj.shape[0]

    def states(self, t0: int, t1: int, dims) -> tp.Tuple[Tensor, tp.Optional[Tensor]]:
        """States t0..t1 (t1 <= steps, ``steps`` being the end) in float64:
        ``([t1 - t0 + 1, B, N], the same of x3 or None)``."""
        X = self.traj[t0 : min(t1 + 1, self.steps)]
        if self.cols is not None:
            X = X.index_select(-1, self.cols)
        X = X.double()
        end = self.parts["latents"]
        X3 = None if self.traj3 is None else self.traj3[t0 : min(t1 + 1, self.steps),
                                                        :, : dims[3]].double()
        if t1 == self.steps:
            X = torch.cat([X, torch.cat(end[:3], dim=-1)[None].double()])
            if X3 is not None:
                X3 = torch.cat([X3, end[3][None].double()])
        return X, X3


@dataclasses.dataclass
class Capture:
    """A held call's steps, as ``capture`` got them."""

    phases: tp.List[Phase]
    held: dict          # the call's parts, which are held
    bits: tp.List[tp.Tuple[str, bool]]
    split: bool
    split_equal: bool   # the split ends with the call's latents
    seconds: float


def _latent_cols(dims, device) -> Tensor:
    _, offs, _ = chain.aligned_layout(dims[:3])
    return torch.cat([torch.arange(d, device=device) + o for d, o in zip(dims[:3], offs)])


def capture(run, inputs, kw, original: tp.Optional[dict] = None) -> Capture:
    """Every state of the held call (``run(*inputs, **kw)``), from ``run``
    launched again with ``capture_stride=1`` (module docstring, 1), and the
    bit checks against the call's own parts ``original``."""
    t_start = time.perf_counter()
    params, latents, target, seed = inputs
    c = chain._chain_args(params, latents, target, seed, **kw)
    if c.bf16_matmul:
        raise ValueError("the step rule holds f32 chains; bf16 ones have their own rules")
    orig = parts_of(run(*inputs, **kw), kw) if original is None else original
    base = {k: v for k, v in kw.items() if k not in _OWN_OPTIONS}
    cols = _latent_cols(c.dims, latents[0].device)
    phases, bits, start = [], [], tuple(latents)
    if c.warm_T:
        wkw = dict(base, T=0, capture_stride=1, emit_warm_opt_state=True,
                   with_pgrads=c.with_pgrads if not c.T else c.warm_pgrads,
                   warm_pgrads=c.warm_pgrads,
                   return_scalars=c.return_scalars and not c.T,
                   **{k: kw[k] for k in ("warm_mu", "warm_nu", "warm_count")
                      if kw.get(k) is not None})
        out = parts_of(run(params, start, target, seed, **wkw), wkw)
        phases.append(Phase("warm", out.pop("traj"), cols, out.pop("traj3", None), out))
        start = out["latents"]
    if c.T:
        lkw = dict(base, warm_T=0, with_pgrads=c.with_pgrads, mixing=c.mixing)
        if c.packed:
            lkw.update(capture_stride=1, return_scalars=c.return_scalars)
            out = parts_of(run(params, start, target, seed, **lkw), lkw)
            phases.append(Phase("langevin", out.pop("traj"), cols, out.pop("traj3", None), out))
        else:
            # no captures here: the state after t steps ends the call of T=t
            states = [torch.cat(start[:3], dim=-1)]
            for t in range(1, c.T):
                ends = run(params, start, target, seed, **dict(lkw, T=t, with_pgrads=False))[0]
                states.append(torch.cat(ends[:3], dim=-1))
            out = parts_of(run(params, start, target, seed, **lkw), lkw)
            phases.append(Phase("langevin", torch.stack(states), None, None, out))
    last = phases[-1].parts
    split = len(phases) == 2
    split_equal = bits_equal(last["latents"], orig["latents"])
    bits = []
    if orig.get("moments") is not None:
        bits.append(("moments", bits_equal(phases[0].parts["moments"], orig["moments"])))
    bits.append(("latents", split_equal))
    if not split_equal:
        # the call's own end is held from the last state the relaunch captured
        phases[-1] = dataclasses.replace(phases[-1], parts=dict(last, latents=orig["latents"]))
    if c.with_pgrads and not (split and c.warm_pgrads):
        bits.append(("gradients", bits_equal(last["pgrads"], orig["pgrads"])))
    if c.return_scalars and not c.scalar_stride:
        bits.append(("the last step's scalars", bits_equal(
            last["scalars"]["loss"][-1:], orig["scalars"]["loss"][-1:])
            and bits_equal(last["scalars"]["energy"][-1:], orig["scalars"]["energy"][-1:])))
    if orig.get("traj") is not None:
        k, ph = c.capture_stride, phases[-1]
        same = bits_equal(orig["traj"], ph.traj[::k])
        if orig.get("traj3") is not None:
            same = same and bits_equal(orig["traj3"], ph.traj3[::k])
        bits.append(("the call's captures", same))
    return Capture(phases, dict(orig), bits, split, split_equal, time.perf_counter() - t_start)


def skip_row(cap: Capture, phase: int, step: int, row: int) -> Capture:
    """``cap`` with one row's update of one step skipped: the state after
    ``step`` of phase ``phase`` keeps that row's state before it (a stale
    read past a barrier), every later state as captured."""
    ph = cap.phases[phase]
    if step + 1 < ph.steps:
        traj = ph.traj.clone()
        traj[step + 1, row] = traj[step, row]
        new = dataclasses.replace(ph, traj=traj)
    else:
        ends = list(ph.parts["latents"])
        X = ph.traj[step, row] if ph.cols is None else ph.traj[step, row].index_select(-1, ph.cols)
        for i, piece in enumerate(X.split([x.shape[1] for x in ends[:3]])):
            ends[i] = ends[i].clone()
            ends[i][row] = piece
        new = dataclasses.replace(ph, parts=dict(ph.parts, latents=tuple(ends)))
    phases = list(cap.phases)
    phases[phase] = new
    return dataclasses.replace(cap, phases=phases)


# -------------------------------------------------------------------- bound


def _ratio(dist: Tensor, bound: Tensor) -> Tensor:
    """dist / bound, 0 where both are 0, inf where the distance is not
    finite or the bound 0."""
    r = torch.where(bound > 0, dist / bound.clamp_min(1e-300),
                    torch.where(dist == 0, 0.0, math.inf))
    return torch.where(torch.isfinite(dist), r, math.inf)


class _Worst:
    """The largest ratio of a part, where it was, and how much was held;
    kept on the device until ``result`` (no synchronisation a step)."""

    def __init__(self):
        self.items, self.checked = [], 0

    def add(self, ratio: Tensor, where) -> None:
        self.checked += ratio.numel()
        if ratio.numel() == 0:
            return
        flat = torch.nan_to_num(ratio.reshape(-1).double(), nan=math.inf)
        i = torch.argmax(flat)
        self.items.append((flat[i], i, tuple(ratio.shape), where))

    def result(self) -> dict:
        if not self.items:
            return {"ratio": 0.0, "at": None, "checked": self.checked, "ok": True}
        k = int(torch.argmax(torch.stack([r for r, *_ in self.items])))
        r, i, shape, where = self.items[k]
        ratio = float(r)
        return {"ratio": ratio, "at": where(np.unravel_index(int(i), shape)),
                "checked": self.checked, "ok": ratio <= 1.0}


@dataclasses.dataclass
class _Model:
    """The held call's float64 operands and float32 constants."""

    c: tp.Any            # the call's _Chain with its constants rounded to float32
    W: tuple             # (w1, w2, w3) float64
    Wa: tuple            # their magnitudes
    b: tuple             # (b0, b1, b2, b3) float64
    y: Tensor
    clamped: tp.Optional[Tensor]
    u: float             # elementwise
    us: float            # product sums
    kh: float            # act's relative error
    F: float             # the first-order factor


def _model(c, params, target, B: int, u: float) -> _Model:
    d0, d1, d2, D = c.dims
    dev = params[1]["w"].device
    c32 = dataclasses.replace(
        c, lr=f32(c.lr), noise_std=f32(c.noise_std), inv_var=f32(c.inv_var),
        inv_var3=None if c.inv_var3 is None else f32(c.inv_var3))
    W = tuple(params[i]["w"].double() for i in (1, 2, 3))
    b = tuple(params[i]["b"].double() for i in range(4))
    y = (target.double() if target is not None
         else torch.zeros((B, D), dtype=torch.float64, device=dev))
    clamped = None
    if c.mask_lo:
        clamped = (torch.arange(D, device=dev) >= c.mask_lo).double()
    us = max(u, U32)
    kh = 2.0 * LIB_ULPS["tanh"] * U32 if c.activation == "tanh" else 0.0
    gmax = max(gamma(max(d0 + 2, d1 + 2, d2 + 1, D), us), 8 * U32)
    return _Model(c32, W, tuple(w.abs() for w in W), b, y, clamped, U32, us, kh,
                  (1.0 + gmax) ** LEVELS)


def _bounds(m: _Model, t: "chain.StepTerms", X: Tensor, X3: tp.Optional[Tensor]) -> dict:
    """First-order bounds of one batch of steps' terms (module docstring)."""
    c, u, us, kh = m.c, m.u, m.us, m.kh
    d0, d1, d2, D = c.dims
    Wa1, Wa2, Wa3 = m.Wa
    ba = [x.abs() for x in m.b]
    h0, h1, h2 = (h.abs() for h in t.h)
    x1, x2 = X[..., d0 : d0 + d1].abs(), X[..., d0 + d1 :].abs()
    pa1, pa2 = h0 @ Wa1, h1 @ Wa2
    out = {"err0": u * t.err0.abs(),
           "e1": gamma(d0 + 2, us) * (x1 + pa1 + ba[1]) + kh * pa1,
           "e2": gamma(d1 + 2, us) * (x2 + pa2 + ba[2]) + kh * pa2}
    BS = None
    if t.logits is not None:
        pa3 = h2 @ Wa3
        out["lg"] = Blg = gamma(d2 + 1, us) * (pa3 + ba[3]) + kh * pa3
        if c.output_pc:
            out["err3"] = Blg + u * t.err3.abs()
            BS = c.inv_var3 * out["err3"] + u * t.S.abs()
        elif c.loss == "bernoulli":
            th = torch.tanh(0.5 * t.logits)
            BS = 0.25 * Blg + LIB_ULPS["tanh"] * u * th.abs() + u * (
                (0.5 + 0.5 * th).abs() + t.S.abs())
        else:
            BS = c.inv_var * (Blg + u * (t.logits - m.y).abs()) + u * t.S.abs()
        if m.clamped is not None:
            BS = BS * m.clamped
    out["S"] = BS
    back = [(gamma(d1, us) * t.e1.abs() + out["e1"]) @ Wa1.T,
            (gamma(d2, us) * t.e2.abs() + out["e2"]) @ Wa2.T]
    back.append(torch.zeros_like(h2) if BS is None
                else (gamma(D, us) * t.S.abs() + BS) @ Wa3.T)
    Bback = torch.cat(back, dim=-1)
    E = torch.cat([t.err0, t.e1, t.e2], dim=-1)
    BE = torch.cat([out["err0"], out["e1"], out["e2"]], dim=-1)
    dH = t.dH.abs()
    BG = BE + dH * Bback + gamma(2, u) * (E.abs() + (dH * t.back).abs())
    if c.activation == "tanh":
        H2 = t.H * t.H
        BG = BG + t.back.abs() * ((4 * LIB_ULPS["tanh"] + 1) * u * H2 + u * dH)
    out["G"] = m.F * BG
    out["G3"] = None if t.G3 is None else m.F * BS
    return out


def _noise(c, B: int, t0: int, t1: int, dev, sincos_err: float):
    """The float64 normals of Langevin steps t0..t1-1 from the exact
    uniforms, and their bounds: ((z [n, B, N], B_z), (z3, B_z3) or None)."""
    t = torch.arange(t0, t1, dtype=torch.int64, device=dev)

    def normals(u1, u2, take_sin):
        r = torch.sqrt(-2.0 * torch.log(u1))
        angle = (2.0 * math.pi) * u2
        z = r * torch.where(take_sin, torch.sin(angle), torch.cos(angle))
        return z, (LIB_ULPS["log"] + 2) * U32 * z.abs() + r * sincos_err

    def draw(idx, seeds, draws):
        u1, u2 = chain.uniforms(chain.counter_bits_at(idx, seeds, draws),
                                chain.counter_bits_at(idx, seeds, draws + 1))
        return u1.double(), u2.double()

    if not c.packed:
        idx, offset, cols = chain._unpacked_grid(tuple(c.dims[:3]), B, torch.device(dev))
        H = idx.shape[1]
        u1, u2 = draw(idx[None], c.seed, 6 * t[:, None, None] + offset[None, None, :])
        u1, u2 = (torch.cat([v, v], dim=-1).index_select(-1, cols) for v in (u1, u2))
        return normals(u1, u2, (cols >= H)[None, None, :]), None
    idx, seeds = chain._noise_index(c, B, dev)
    dp = 4 if c.output_pc else 2
    odd = (t % 2 == 1)[:, None, None]
    draws = (dp * (t // 2))[:, None, None]
    z = normals(*draw(idx[None], seeds[None], draws), odd)
    z3 = None
    if c.output_pc:
        z3 = normals(*draw(chain._noise_index3(c, B, dev)[None], seeds[None], draws + 2), odd)
    return z, z3


def _scalars(m: _Model, t: "chain.StepTerms", bd: dict) -> tp.Tuple[Tensor, Tensor, Tensor, Tensor]:
    """(loss, its bound, energy, its bound) of each step [n] in float64."""
    c, u = m.c, m.u
    dims = (1, 2)
    parts = [(t.err0, bd["err0"]), (t.e1, bd["e1"]), (t.e2, bd["e2"])]
    n = t.err0.shape[1] * sum(c.dims[:3])
    sq = sum((e * e).sum(dims) for e, _ in parts)
    energy = 0.5 * sq
    B_energy = 0.5 * sum((2 * e.abs() * b + b * b).sum(dims) for e, b in parts) + \
        gamma(n + 2) * energy
    if c.output_pc:
        e3, b3 = t.err3, bd["err3"]
        s3 = 0.5 * c.inv_var3 * (e3 * e3).sum(dims)
        energy = energy + s3
        B_energy = (B_energy + 0.5 * c.inv_var3 * (2 * e3.abs() * b3 + b3 * b3).sum(dims)
                    + gamma(e3.shape[1] * e3.shape[2] + 3) * s3)
    if c.loss == "none" or c.output_pc:
        zero = torch.zeros_like(energy)
        return zero, zero, energy, m.F * B_energy
    lg, y, Blg = t.logits, m.y, bd["lg"]
    if c.loss == "bernoulli":
        a, ly = torch.clamp(lg, min=0.0), lg * y
        cterm = torch.log1p(torch.exp(-lg.abs()))
        elem = a - ly + cterm
        sig = 0.5 + 0.5 * torch.tanh(0.5 * lg)
        B_elem = ((sig - y).abs() * Blg + gamma(4) * (a + ly.abs() + cterm)
                  + 2 * u * (LIB_ULPS["exp"] + LIB_ULPS["log1p"]) * cterm)
    else:
        elem = 0.5 * c.inv_var * (lg - y) ** 2
        B_elem = c.inv_var * (lg - y).abs() * Blg + gamma(3) * elem
    if m.clamped is not None:
        elem, B_elem = elem * m.clamped, B_elem * m.clamped
        n_loss = int(m.clamped.sum()) * lg.shape[1]
    else:
        n_loss = lg.shape[1] * lg.shape[2]
    loss = elem.sum(dims)
    B_loss = B_elem.sum(dims) + gamma(n_loss) * elem.abs().sum(dims)
    return loss, m.F * B_loss, energy, m.F * B_energy


GRAD_NAMES = ("W1", "W2", "W3", "b0", "b1", "b2", "b3")


def _grad_list(pgrads) -> list:
    """A chain's gradient sums in the order of GRAD_NAMES."""
    return [pgrads[1]["w"], pgrads[2]["w"], pgrads[3]["w"],
            pgrads[0]["b"], pgrads[1]["b"], pgrads[2]["b"], pgrads[3]["b"]]


class _Grads:
    """The float64 gradient sums over the sampling steps and their bounds."""

    def __init__(self, m: _Model, n_terms: int):
        d0, d1, d2, D = m.c.dims
        shapes = ((d0, d1), (d1, d2), (d2, D), (d0,), (d1,), (d2,), (D,))
        self.m, self.gn = m, gamma(max(n_terms, 1))
        self.F = m.F * (1.0 + self.gn) ** 2
        self.g, self.b = ([torch.zeros(s, dtype=torch.float64, device=m.y.device) for s in shapes]
                          for _ in range(2))

    def add(self, t: "chain.StepTerms", bd: dict) -> None:
        m, gn = self.m, self.gn
        h0, h1, h2 = (h.reshape(-1, h.shape[-1]) for h in t.h)
        flat = lambda x: x.reshape(-1, x.shape[-1])  # noqa: E731
        e1, e2, err0 = flat(t.e1), flat(t.e2), flat(t.err0)
        B1, B2, B0 = flat(bd["e1"]), flat(bd["e2"]), flat(bd["err0"])
        self.g[0] -= h0.T @ e1
        self.g[1] -= h1.T @ e2
        self.b[0] += h0.abs().T @ (B1 + (gn + m.kh) * e1.abs())
        self.b[1] += h1.abs().T @ (B2 + (gn + m.kh) * e2.abs())
        for i, (e, be) in enumerate(((err0, B0), (e1, B1), (e2, B2))):
            self.g[3 + i] -= e.sum(0)
            self.b[3 + i] += (be + gn * e.abs()).sum(0)
        if t.S is not None:
            S, BS = flat(t.S), flat(bd["S"])
            self.g[2] += h2.T @ S
            self.b[2] += h2.abs().T @ (BS + (gn + m.kh) * S.abs())
            self.g[6] += S.sum(0)
            self.b[6] += (BS + gn * S.abs()).sum(0)

    def hold(self, pgrads, worst: _Worst) -> None:
        for name, k, g, b in zip(GRAD_NAMES, _grad_list(pgrads), self.g, self.b):
            worst.add(_ratio((k.double() - g).abs(), self.F * b),
                      lambda i, name=name: f"g{name}{list(map(int, i))}")
        w0 = pgrads[0]["w"]
        worst.add(torch.where(w0 == 0, 0.0, math.inf).double(), lambda i: "gW0 (must be 0)")


def _each(terms: "chain.StepTerms", bd: dict, fn):
    """``terms`` and the bounds ``bd`` with ``fn`` applied to every tensor
    (a slice of the steps)."""
    def one(v):
        if v is None:
            return None
        return tuple(fn(h) for h in v) if isinstance(v, tuple) else fn(v)
    return (chain.StepTerms(*[one(getattr(terms, f.name)) for f in dataclasses.fields(terms)]),
            {k: one(v) for k, v in bd.items()})


def _interval_ratio(x: Tensor, lo: Tensor, hi: Tensor, center: Tensor) -> Tensor:
    """How far ``x`` lies from ``center`` (the float64 value) towards the
    interval's end on its side: at most 1 inside [lo, hi]."""
    d = x.double() - center
    return torch.where(d >= 0, _ratio(d, hi - center), _ratio(-d, center - lo))


def _scan(a: float, x0: Tensor, u: Tensor, carry: int = 128) -> Tensor:
    """x_k = a x_{k-1} + u_k for k = 1..n (``u`` [n, ...]) from ``x0``: the
    sequence [n, ...], as a^k (x0 + sum_{s<=k} u_s / a^s) over runs of at
    most ``carry`` steps (float64: a^-carry stays far from overflow, and the
    sum's error stays at 2^-53 of the latest terms)."""
    out = []
    for i in range(0, u.shape[0], carry):
        part = u[i : i + carry]
        n = part.shape[0]
        p = a ** torch.arange(1, n + 1, dtype=torch.float64, device=u.device)
        p = p.reshape((n,) + (1,) * (u.dim() - 1))
        xs = p * (x0 + torch.cumsum(part / p, dim=0))
        out.append(xs)
        x0 = xs[-1]
    return torch.cat(out)


class _Moments:
    """Adam's moments carried along the chain's own states: m and v as
    intervals that hold every value the chain's float32 moments can take,
    and their float64 values from the float64 gradients (the centers).
    Every average is linear in the moment before it, so a run of steps is
    taken at once (``_scan``)."""

    def __init__(self, m: Tensor, v: Tensor):
        self.m = [m, m.clone(), m.clone()]   # lo, hi, center
        self.v = [v, v.clone(), v.clone()]
        self.m_abs = m.abs()                 # at least |m| anywhere in its interval

    def update(self, g: Tensor, bg: Tensor, b1, b2, omb1, omb2) -> tp.Tuple[list, list]:
        """Steps [n, ...] whose float32 gradients lie within ``bg`` of ``g``:
        the moments after each, ``([m_lo, m_hi, m_c], [v_lo, v_hi, v_c])``
        [n, ...] each: the averages' ends widened by their roundings (g(2)
        of m's terms, g(3) of v's, each rounding at most UNDERFLOW off below
        the normal range); v's lower end may fall below 0, which its use
        clamps."""
        (m_lo, m_hi, m_c), (v_lo, v_hi, v_c) = self.m, self.v
        g_lo, g_hi = g - bg, g + bg
        g_abs = torch.maximum(g_lo.abs(), g_hi.abs())
        sq_hi = g_abs * g_abs
        sq_lo = torch.where((g_lo <= 0) & (g_hi >= 0), torch.zeros_like(g_lo),
                            torch.minimum(g_lo * g_lo, g_hi * g_hi))
        g2, g3 = gamma(2), gamma(3)
        # a bound of |m| and v's upper end before each step
        m_abs = _scan(b1 * (1 + g2), self.m_abs, (1 + g2) * omb1 * g_abs + 2 * UNDERFLOW)
        v_his = _scan(b2 * (1 + g3), v_hi, (1 + g3) * omb2 * sq_hi + 3 * UNDERFLOW)
        m_before = torch.cat([self.m_abs[None], m_abs[:-1]])
        v_before = torch.cat([v_hi[None], v_his[:-1]])
        m_r = g2 * (b1 * m_before + omb1 * g_abs) + 2 * UNDERFLOW
        v_r = g3 * (b2 * v_before + omb2 * sq_hi) + 3 * UNDERFLOW
        ms = [_scan(b1, m_lo, omb1 * g_lo - m_r), _scan(b1, m_hi, omb1 * g_hi + m_r),
              _scan(b1, m_c, omb1 * g)]
        vs = [_scan(b2, v_lo, omb2 * sq_lo - v_r), v_his, _scan(b2, v_c, omb2 * g * g)]
        self.m, self.v, self.m_abs = [t[-1] for t in ms], [t[-1] for t in vs], m_abs[-1]
        return ms, vs


def _adam_interval(x: Tensor, ms, vs, c1, c2, lr, eps) -> tp.Tuple[Tensor, Tensor, Tensor]:
    """(lo, hi, center) of x - lr (m/c1) / (sqrt(v/c2) + eps) in float32
    for the moments' intervals ``ms``, ``vs`` (``_Moments.update``): the
    step's range over the m-v box from its corners, widened by its own six
    roundings, the subtraction's and UPDATE_ULPS; the center from the
    moments' centers.  ``c1``, ``c2`` broadcast against ``x``."""
    (m_lo, m_hi, m_c), (v_lo, v_hi, v_c) = ms, vs
    v_lo = v_lo.clamp_min(0.0)
    zero = torch.zeros_like(x)
    lo = hi = None
    for mm in (m_lo, m_hi):
        for vv in (v_lo, v_hi):
            step = chain.adam_step(zero, mm, vv, c1, c2, lr, eps)   # -step
            lo = step if lo is None else torch.minimum(lo, step)
            hi = step if hi is None else torch.maximum(hi, step)
    lo = x + lo - (gamma(6) * lo.abs() + 6 * UNDERFLOW)
    hi = x + hi + (gamma(6) * hi.abs() + 6 * UNDERFLOW)
    far = torch.maximum(lo.abs(), hi.abs())
    r = U32 * far + 2 * UPDATE_ULPS * U32 * torch.maximum(far, x.abs()) + UNDERFLOW
    return lo - r, hi + r, chain.adam_step(x, m_c, v_c, c1, c2, lr, eps)


def param_hold(p0, p1, grads, scale: float, lr: float, betas=(0.9, 0.999),
               eps: float = 1e-8) -> dict:
    """The parameters ``p1`` after the first Adam step (optax's order) from
    ``p0`` with the gradient sums ``grads`` divided by ``scale``, held as a
    warm step is (module docstring) to the interval that the chain's own
    gradients give: the division rounds each gradient once.  Returns the
    part's result (``ratio``, ``at``, ``checked``, ``ok``)."""
    b1, b2 = betas
    omb1, omb2 = f32(1.0 - b1), f32(1.0 - b2)
    c1 = f32(np.float32(1.0) - np.power(np.float32(b1), np.float32(1)))
    c2 = f32(np.float32(1.0) - np.power(np.float32(b2), np.float32(1)))
    worst = _Worst()
    for i, (a, b, g) in enumerate(zip(p0, p1, grads)):
        for k in ("w", "b"):
            gs = g[k].double() / scale
            mo = _Moments(torch.zeros_like(gs), torch.zeros_like(gs))
            ms, vs = mo.update(gs[None], U32 * gs.abs()[None], f32(b1), f32(b2), omb1, omb2)
            lo, hi, center = _adam_interval(a[k].double()[None], ms, vs, c1, c2, f32(lr),
                                            f32(eps))
            worst.add(_interval_ratio(b[k][None], lo, hi, center),
                      lambda j, i=i, k=k: f"{k}{i}{list(map(int, j[1:]))}")
    return worst.result()


# --------------------------------------------------------------------- hold


def _scalar_steps(c, scalars) -> tp.List[tp.Tuple[int, int]]:
    """(row of the call's scalars, step of the captured phase) pairs."""
    n = scalars["loss"].shape[0]
    steps = c.T if c.T else c.warm_T
    if c.scalar_stride:
        at = [i * c.scalar_stride for i in range(n - 1)]
    elif c.capture_stride:
        at = [i * c.capture_stride for i in range(n - 1)]
    else:
        at = []
    return list(enumerate(at + [steps - 1]))


def hold(cap: Capture, inputs, kw, *, sincos_err: float, u: float = U32) -> dict:
    """Hold every captured step of ``cap`` (module docstring, 2).  Returns
    ``{"ok", "parts": {name: {"ratio", "at", "checked", "ok"}}, "bits",
    "steps", "seconds", "split", "split_equal", "grads64"}``, the last the
    float64 gradient sums over the captured states (None without
    gradients)."""
    t_start = time.perf_counter()
    params, latents, target, seed = inputs
    c = chain._chain_args(params, latents, target, seed, **kw)
    B = latents[0].shape[0]
    dev = latents[0].device
    n_sampling = (max(c.T - c.mixing, 0) if c.with_pgrads else 0) + (1 if c.warm_pgrads else 0)
    n_grad = B * n_sampling
    m = _model(c, params, target, B, u)
    act = chain.activation_fn(c.activation)
    grads = _Grads(m, n_grad) if c.with_pgrads else None
    held = cap.held
    worst = {"warm steps": _Worst(), "Langevin steps": _Worst()}
    scal_at = {}
    if held.get("scalars") is not None:
        for row, step in _scalar_steps(c, held["scalars"]):
            scal_at.setdefault(step, []).append(row)
        worst["scalars"] = _Worst()
    chunk = max(1, CHUNK_ROWS // B)
    steps_held = 0
    for ph in cap.phases:
        warm = ph.kind == "warm"
        scalars_here = (warm and not c.T) or (not warm)
        if warm:
            b1, b2 = f32(c.warm_b1), f32(c.warm_b2)
            omb1, omb2 = f32(1.0 - c.warm_b1), f32(1.0 - c.warm_b2)
            lr_w, eps = f32(c.warm_lr), f32(c.warm_eps)
            corrections = list(chain.bias_corrections(c))
            N = sum(c.dims[:3])

            def start(name):
                given = kw.get(name)
                if given is None:
                    z = torch.zeros((B, N), dtype=torch.float64, device=dev)
                    z3 = (torch.zeros((B, c.dims[3]), dtype=torch.float64, device=dev)
                          if c.output_pc else None)
                    return z, z3
                return (torch.cat([t.double() for t in given[:3]], dim=-1),
                        given[3].double() if c.output_pc else None)
            (m0, m30), (v0, v30) = start("warm_mu"), start("warm_nu")
            mom = _Moments(m0, v0)
            mom3 = None if m30 is None else _Moments(m30, v30)
        for t0 in range(0, ph.steps, chunk):
            t1 = min(t0 + chunk, ph.steps)
            X, X3 = ph.states(t0, t1, c.dims)
            Xc, Xn = X[:-1], X[1:]
            X3c, X3n = (None, None) if X3 is None else (X3[:-1], X3[1:])
            terms = chain.step_terms(m.c, m.W, m.b, Xc, X3c, m.y, m.clamped, act)
            bd = _bounds(m, terms, Xc, X3c)
            if warm:
                n = t1 - t0
                cs = torch.tensor(corrections[t0:t1], dtype=torch.float64, device=dev)
                c1, c2 = (cs[:, k].reshape(n, 1, 1) for k in (0, 1))
                pairs = [(Xc, Xn, terms.G, bd["G"], mom)]
                if mom3 is not None:
                    pairs.append((X3c, X3n, terms.G3, bd["G3"], mom3))
                for x, xn, g, bg, mm in pairs:
                    ms, vs = mm.update(g, bg, b1, b2, omb1, omb2)
                    lo, hi, center = _adam_interval(x, ms, vs, c1, c2, lr_w, eps)
                    worst["warm steps"].add(
                        _interval_ratio(xn, lo, hi, center),
                        lambda j, t0=t0: f"step {t0 + int(j[0])}, row {int(j[1])}")
                    del ms, vs, lo, hi, center
                if grads is not None and c.warm_pgrads and t1 == ph.steps:
                    grads.add(*_each(terms, bd, lambda v: v[-1:]))
            else:
                z = z3 = None
                if c.noise_std > 0.0:
                    z, z3 = _noise(c, B, t0, t1, dev, sincos_err)
                for x, xn, g, bg, zz in [(Xc, Xn, terms.G, bd["G"], z)] + (
                        [] if X3c is None else [(X3c, X3n, terms.G3, bd["G3"], z3)]):
                    zv = None if zz is None else zz[0]
                    center = chain.langevin_update(x, g, zv, m.c.lr, m.c.noise_std)
                    noise = 0.0 if zz is None else m.c.noise_std * (zz[1] + gamma(3) * zz[0].abs())
                    # bg carries the first-order factor already
                    bound = (m.c.lr * bg + m.F * (noise + gamma(3) * (x.abs() + m.c.lr * g.abs()))
                             + 2 * UPDATE_ULPS * U32 * torch.maximum(center.abs(), x.abs())
                             + 3 * UNDERFLOW)
                    worst["Langevin steps"].add(
                        _ratio((xn - center).abs(), bound),
                        lambda j, t0=t0: f"step {t0 + int(j[0])}, row {int(j[1])}")
                if grads is not None and t1 > c.mixing:
                    k = max(c.mixing - t0, 0)
                    grads.add(*_each(terms, bd, lambda v, k=k: v[k:]))
            if scalars_here and scal_at:
                want = [s for s in range(t0, t1) if s in scal_at]
                if want:
                    idx = torch.tensor([s - t0 for s in want], device=dev)
                    loss, bl, energy, be = _scalars(
                        m, *_each(terms, bd, lambda v: v.index_select(0, idx)))
                    pairs = [(j, row) for j, s in enumerate(want) for row in scal_at[s]]
                    at = torch.tensor([j for j, _ in pairs], device=dev)
                    rows = torch.tensor([row for _, row in pairs], device=dev)
                    for name, val, bnd in (("loss", loss, bl), ("energy", energy, be)):
                        got = held["scalars"][name].to(dev).double().index_select(0, rows)
                        worst["scalars"].add(
                            _ratio((got - val.index_select(0, at)).abs(), bnd.index_select(0, at)),
                            lambda i, name=name, pairs=pairs, want=want:
                                f"{name} of step {want[pairs[int(i[0])][0]]}")
            steps_held += t1 - t0
            del X, X3, Xc, Xn, terms, bd
        if warm and ph.parts.get("moments") is not None:
            worst["moments"] = _Worst()
            mo = ph.parts["moments"]
            cols = _latent_cols(c.dims, dev)
            given = [(mo[0].index_select(-1, cols), mom.m), (mo[1].index_select(-1, cols), mom.v)]
            if mom3 is not None:
                D = c.dims[3]
                given += [(mo[2][:, :D], mom3.m), (mo[3][:, :D], mom3.v)]
            for name, (got, (lo, hi, center)) in zip(("m", "v", "m3", "v3"), given):
                worst["moments"].add(_interval_ratio(got, lo, hi, center),
                                     lambda j, name=name: f"{name}, row {int(j[0])}")
    if grads is not None:
        worst["pgrads"] = _Worst()
        grads.hold(held["pgrads"], worst["pgrads"])
    elif held.get("pgrads") is not None:
        worst["pgrads"] = _Worst()
        worst["pgrads"].add(torch.full((1,), math.inf, dtype=torch.float64, device=dev),
                            lambda i: "gradients without with_pgrads")
    parts = {k: w.result() for k, w in worst.items() if w.checked}
    ok = all(p["ok"] for p in parts.values()) and all(ok for _, ok in cap.bits)
    return {"ok": ok, "parts": parts, "bits": cap.bits, "steps": steps_held,
            "seconds": time.perf_counter() - t_start, "capture_seconds": cap.seconds,
            "split": cap.split, "split_equal": cap.split_equal,
            "grads64": None if grads is None else grads.g}


def grad_distance(v: dict, pgrads) -> tp.Tuple[float, str]:
    """The largest distance of the gradient sums ``pgrads`` from the float64
    sums over the chain's own captured states (``hold``'s ``grads64``), each
    tensor's relative to its largest entry, and that tensor's name; (0, "")
    where the call sums no gradients.  Not part of the verdict: the bound of
    a sum of n = B x steps terms in any order, g(n) of the terms'
    magnitudes, is 1.5e-3 of them at n = 25,600, so a fault that moves
    every gradient by less than that passes it; a caller holds this
    distance to a tolerance of its own."""
    if v["grads64"] is None:
        return 0.0, ""
    far = [(float((k.double() - g).abs().max() / g.abs().max().clamp_min(1e-300)), name)
           for name, k, g in zip(GRAD_NAMES, _grad_list(pgrads), v["grads64"])]
    return max(far)


def grads_changed(cap: Capture, fn) -> Capture:
    """``cap`` with ``fn`` applied to each of the call's gradient sums (a
    fault in the gradients alone)."""
    pgrads = tuple({k: fn(x) for k, x in p.items()} for p in cap.held["pgrads"])
    return dataclasses.replace(cap, held=dict(cap.held, pgrads=pgrads))


def verdict_text(v: dict) -> str:
    """One line: the verdict, each part's largest ratio with where it lies,
    the bit checks, the steps held and the seconds."""
    parts = "; ".join(f"{name} {p['ratio']:.3g} at {p['at']} ({p['checked']} held)"
                      for name, p in v["parts"].items())
    bits = ", ".join(f"{what} {'same' if ok else 'DIFFER'}" for what, ok in v["bits"])
    split = ""
    if v["split"]:
        split = ("; split into warm and Langevin calls"
                 + ("" if v["split_equal"] else ", which end with OTHER bits than the call"))
    return (f"step rule {'holds' if v['ok'] else 'FAILS'}: largest ratio to the bound: "
            f"{parts}; the relaunch's bits: {bits}{split}; {v['steps']} steps held in "
            f"{v['seconds']:.2f} s (capture {v['capture_seconds']:.2f} s)")


def check(run, inputs, kw, *, sincos_err: float, original=None, u: float = U32) -> dict:
    """``capture`` then ``hold``."""
    return hold(capture(run, inputs, kw, original), inputs, kw, sincos_err=sincos_err, u=u)
