"""The step rule (``step_rule.py``) on the CPU: every step of a chain held
from the chain's own state to a derived rounding bound.

Here the plain version, its faulty copies, other correct orders and the JAX
package's own chain stand in for the kernel, at small widths:

- f32 dot products summed in any order stay within gamma_n sum |a b|
  (a hypothesis property: random orders, pairwise, reversed, fused, and
  float64 rounded once);
- correct orders pass on every draw: the plain version, its witnesses (its
  products summed in reverse and its latents moved by up to an ulp as each
  step starts, the move keyed by the latents' bits so that a split chain
  moves as the whole does), its products taken in float64 and rounded
  once, and ``mcpc_chain_pallas(..., interpret=True)`` on the same numpy
  inputs; over relu and tanh, the Bernoulli, Gaussian, masked and no loss,
  the output-PC site, warm and Langevin phases with gradients (``mixing``,
  ``warm_pgrads``) and the unpacked chain;
- every fault fails: the fault catalogue of ``test_torch_chain_holds.py``,
  the smoke's four faults through a chain's arguments, and one row's update
  skipped for one step, in the row where correct orders part least and in
  the one where they part most, on figure 2's PC posterior and the PC mse
  batch at small width, made by the chain and injected into its captures;
- a fault of the gradient sums alone (rounded to bf16, or scaled by 1 +
  1e-4) fails both the step rule and the smoke's gradient check;
- a warm and Langevin call split in two ends with the call's bits, a split
  that does not fails, and the parameters' Adam step is held from the
  chain's own gradients.
"""

import functools
import importlib
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import montecarlopredictivecoding_tpu_torch as mt
from montecarlopredictivecoding_tpu.ops import mcpc_chain_pallas
from montecarlopredictivecoding_tpu.ops import pallas_mcpc as jops

torch.set_num_threads(1)

ROOT = str(pathlib.Path(__file__).resolve().parents[1])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
sr = importlib.import_module("step_rule")
smoke = importlib.import_module("chip_smoke")
sys.path.insert(0, str(pathlib.Path(ROOT) / "scripts"))
cases = importlib.import_module("rule_cases")
chain = importlib.import_module("montecarlopredictivecoding_tpu_torch.ops.mcpc_chain")

DIMS, B = (4, 16, 16, 32), 16
DRAWS = range(8)
# each configuration with its activation, the output-PC site's variance
# (None: a sensory loss) and the chain's options
CONFIGS = {
    "relu bernoulli, warm + Langevin, gradients, two tiles, captures": (
        "relu", None, dict(warm_T=20, warm_lr=0.1, T=30, lr=0.03, noise_var=2.0, batch_tile=8,
                           capture_stride=1, return_scalars=True, with_pgrads=True, mixing=20,
                           emit_warm_opt_state=True)),
    "tanh gaussian, warm + Langevin, gradients": (
        "tanh", None, dict(warm_T=10, warm_lr=0.1, T=20, lr=0.03, noise_var=2.0,
                           loss="gaussian", input_var=0.5, return_scalars=True,
                           with_pgrads=True, mixing=8)),
    "relu masked, warm-only from given moments, warm_pgrads, scalar slots": (
        "relu", None, dict(warm_T=25, warm_lr=0.1, T=0, lr=0.03, loss="bernoulli_mask",
                           mask_perc=0.5, with_pgrads=True, warm_pgrads=True,
                           return_scalars=True, scalar_stride=4, warm_count=6)),
    "tanh none, warm + Langevin, captures every 3": (
        "tanh", None, dict(warm_T=10, warm_lr=0.1, T=20, lr=0.03, noise_var=2.0, loss="none",
                           capture_stride=3, return_scalars=True)),
    "output-PC site, warm + Langevin, gradients": (
        "relu", 0.5, dict(output_var=0.5, loss="none", warm_T=10, warm_lr=0.1, T=20, lr=0.05,
                          noise_var=2.0, with_pgrads=True, mixing=10, capture_stride=1,
                          return_scalars=True, emit_warm_opt_state=True)),
    "unpacked, gradients": (
        "relu", None, dict(T=10, lr=0.03, noise_var=2.0, packed=False, with_pgrads=True,
                           mixing=4)),
}
FAULT_CONFIG = "relu bernoulli, warm + Langevin, gradients, two tiles, captures"
# figure 2's PC posterior (every Adam step captured, masked) and the PC mse
# batch (tanh, the last Adam step's gradients), at small width
SKIP_CONFIGS = {
    "figure 2's PC posterior": ("relu", dict(warm_T=40, warm_lr=0.1, T=0, lr=0.03,
                                             loss="bernoulli_mask", mask_perc=0.5,
                                             capture_stride=1, return_scalars=True)),
    "PC mse batch": ("tanh", dict(warm_T=40, warm_lr=0.1, T=0, lr=0.1, with_pgrads=True,
                                  warm_pgrads=True)),
}
# the mse MCPC batch at small width, where the smoke passes ARG_FAULTS
ARG_KW = dict(warm_T=25, warm_lr=0.7, T=15, lr=0.1, noise_var=2.0, mixing=5, with_pgrads=True,
              loss="bernoulli")


@pytest.fixture(scope="module")
def sincos_err():
    """The plain version's sincos_2pi over all its inputs."""
    return sr.sincos_error(chain.sincos_2pi)


def case(seed, activation="relu", output_var=None, loss="bernoulli", batch=B, dims=DIMS):
    """Random parameters, fed-forward latents (x3 moved off its prediction
    at an output-PC site) and a target for the loss."""
    g = torch.Generator().manual_seed(seed)
    out_pc = None if output_var is None else mt.PC(energy_fn=mt.scaled_gaussian_energy(output_var))
    model = mt.make_mlp_model(*dims, activation=activation, output_pc=out_pc)
    params = model.init(g, device="cpu")
    latents = model.init_latents(params, torch.zeros(batch, dims[0]), g)
    if output_var is not None:
        return params, smoke.off_prediction(torch, latents, g), None
    target = (torch.rand(batch, dims[3], generator=g) > 0.5).float()
    if loss.startswith("gaussian"):
        target = 2.0 * target - 1.0
    return params, latents, target


def inputs_of(name, draw):
    """The inputs and options of a configuration's draw (given moments
    drawn for a resumed warm phase)."""
    act, output_var, kw = CONFIGS[name]
    params, latents, target = case(100 + draw, act, output_var, kw.get("loss", "bernoulli"))
    kw = dict(kw, activation=act)
    if "warm_count" in kw:
        g = torch.Generator().manual_seed(900 + draw)
        kw["warm_mu"] = tuple(0.1 * torch.randn(x.shape, generator=g) for x in latents)
        kw["warm_nu"] = tuple(0.01 * torch.rand(x.shape, generator=g) for x in latents)
    return (params, latents, target, draw), kw


plain = chain.mcpc_chain_reference


def witness(rows, seed, params):
    """The plain version as the row rule's witnesses take it (products
    summed in reverse, latents moved by up to an ulp as each step starts),
    each move keyed by the element's bits (``jittered_rounding(keyed=True)``)."""
    def run(*args, **kw):
        with smoke.jittered_rounding(torch, chain, rows, seed, params, keyed=True):
            return plain(*args, **kw)
    return run


def float64_products(*args, **kw):
    with cases.other_order("float64"):
        return plain(*args, **kw)


def _to_torch(x):
    if isinstance(x, dict):
        return {k: _to_torch(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return tuple(_to_torch(v) for v in x)
    if x is None:
        return None
    return torch.from_numpy(np.array(x))


def jax_chain(params, latents, target, seed, **kw):
    """``mcpc_chain_pallas(..., interpret=True)`` on the same arrays, its
    result as tensors."""
    kw = {k: (tuple(jnp.asarray(m.numpy()) for m in v) if k in ("warm_mu", "warm_nu")
              else jnp.int32(v) if k == "warm_count" else v) for k, v in kw.items()}
    out = mcpc_chain_pallas(
        tuple({k: v.numpy() for k, v in p.items()} for p in params),
        tuple(jnp.asarray(x.numpy()) for x in latents),
        None if target is None else jnp.asarray(target.numpy()), jnp.int32(seed),
        interpret=True, **kw)
    return _to_torch(out)


@functools.lru_cache(maxsize=None)
def jax_sincos_err():
    """The JAX package's _sincos_2pi over all its inputs."""
    return sr.sincos_error(lambda u: tuple(torch.from_numpy(np.array(v)) for v in
                                           jops._sincos_2pi(jnp.asarray(u.numpy()))))


# --------------------------------------------------------- the sum bound


def _sums(a, b, how, rng):
    """An f32 sum of a * b taken as ``how``."""
    p = (a.astype(np.float64) * b.astype(np.float64))
    if how == "float64 rounded once":
        return np.float32(p.sum())
    prods = (a * b).astype(np.float32)
    if how == "fused":   # each product exact, rounded once with its addition
        acc = np.float32(0.0)
        for x in p:
            acc = np.float32(np.float64(acc) + x)
        return acc
    if how == "reversed":
        prods = prods[::-1]
    elif how == "random order":
        prods = prods[rng.permutation(len(prods))]
    if how == "pairwise":
        while len(prods) > 1:
            if len(prods) % 2:
                prods = np.append(prods, np.float32(0.0))
            prods = (prods[0::2] + prods[1::2]).astype(np.float32)
        return prods[0]
    acc = np.float32(0.0)
    for x in prods:
        acc = np.float32(acc + x)
    return acc


@settings(max_examples=60, deadline=None)
@given(n=st.integers(1, 300), seed=st.integers(0, 2**31 - 1),
       scale=st.sampled_from([1e-3, 1.0, 1e3]),
       how=st.sampled_from(["random order", "pairwise", "reversed", "in order", "fused",
                            "float64 rounded once"]))
def test_f32_dot_products_stay_within_gamma_n(n, seed, scale, how):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal(n) * scale).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    exact = float((a.astype(np.float64) * b.astype(np.float64)).sum())
    got = float(_sums(a, b, how, rng))
    bound = sr.gamma(n) * float(np.abs(a.astype(np.float64) * b.astype(np.float64)).sum())
    assert abs(got - exact) <= bound, (how, got, exact, bound)


def test_sincos_error_covers_every_input(sincos_err):
    """Over all 2^23 inputs the plain sincos_2pi and the JAX package's err
    by under 1e-6 (its docstring: about 5e-7)."""
    assert 0.0 < sincos_err < 1e-6
    assert 0.0 < jax_sincos_err() < 1e-6


# ------------------------------------------------------ correct orders

ORDERS = ("plain", "witness", "float64 products", "the JAX chain")


def run_of(order, params, draw):
    if order == "plain":
        return plain
    if order == "witness":
        return witness(B, 40 + draw, params)
    if order == "float64 products":
        return float64_products
    return jax_chain


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_correct_orders_pass_the_step_rule(config, order, sincos_err):
    err = jax_sincos_err() if order == "the JAX chain" else sincos_err
    failed, worst = [], 0.0
    for draw in DRAWS:
        inputs, kw = inputs_of(config, draw)
        v = sr.check(run_of(order, inputs[0], draw), inputs, kw, sincos_err=err)
        worst = max([worst] + [p["ratio"] for p in v["parts"].values()])
        if not v["ok"]:
            failed.append(f"draw {draw}: {sr.verdict_text(v)}")
    assert not failed, "\n".join(failed)
    assert 0.0 < worst <= 1.0


def test_a_split_chain_ends_with_the_whole_chains_bits():
    inputs, kw = inputs_of(FAULT_CONFIG, 0)
    cap = sr.capture(plain, inputs, kw)
    assert cap.split and cap.split_equal and all(ok for _, ok in cap.bits)
    assert [p.kind for p in cap.phases] == ["warm", "langevin"]
    assert [p.steps for p in cap.phases] == [kw["warm_T"], kw["T"]]


def test_a_split_that_ends_with_other_bits_is_held_as_the_split_gives(sincos_err):
    """Where the warm-only and Langevin-only calls do not end with the
    whole call's bits (here the whole call's latents are an ulp off), the
    hold fails on that bit check, though every step, the call's own end
    held from the split's last captured state, lies within its bound."""
    inputs, kw = inputs_of(FAULT_CONFIG, 1)

    def run(*args, **k):
        out = list(plain(*args, **k))
        if k.get("warm_T") and k.get("T"):
            out[0] = tuple(torch.nextafter(x, torch.full_like(x, float("inf"))) for x in out[0])
        return tuple(out)
    cap = sr.capture(run, inputs, kw)
    assert cap.split and not cap.split_equal and ("latents", False) in cap.bits
    assert sr.bits_equal(cap.phases[-1].parts["latents"], cap.held["latents"])
    v = sr.hold(cap, inputs, kw, sincos_err=sincos_err)
    assert not v["ok"] and "OTHER bits" in sr.verdict_text(v), sr.verdict_text(v)
    assert all(p["ok"] for p in v["parts"].values()), sr.verdict_text(v)


# ---------------------------------------------------------------- faults


def one_step_fewer(params, latents, target, seed, **kw):
    """A Langevin phase of T - 1 steps in the full chain's shapes: the last
    capture repeats the end, the last scalar row repeats."""
    if not kw.get("T"):
        return plain(params, latents, target, seed, **kw)
    parts = sr.parts_of(plain(params, latents, target, seed, **dict(kw, T=kw["T"] - 1)), kw)
    out = [parts["latents"], parts["pgrads"]]
    if kw.get("capture_stride"):
        end = chain._pack_aligned(parts["latents"], DIMS[:3])[None]
        out.append(torch.cat([parts["traj"], end])[: -(-kw["T"] // kw["capture_stride"])])
    if kw.get("return_scalars"):
        out.append({k: torch.cat([v[:-1], v[-2:]])[-(-kw["T"] // max(kw.get(
            "capture_stride", 0), 1)) - 1 if kw.get("capture_stride") else -1:]
            for k, v in parts["scalars"].items()})
    if kw.get("emit_warm_opt_state"):
        out.append(parts["moments"])
    return tuple(out)


def other_tile_seed(saved):
    def index(c, batch, device):
        idx, seeds = saved(c, batch, device)
        return idx, seeds + (torch.arange(batch, device=device) >= c.tile)[:, None]
    return index


def patched_run(name, fn):
    def run(*args, **kw):
        with cases.patched(chain, name, fn):
            return plain(*args, **kw)
    return run


def pad_rows_in_gradients(params, latents, target, seed, **kw):
    """The chain, its gradients summed over a tile of pad rows too."""
    out = list(plain(params, latents, target, seed, **kw))
    if kw.get("with_pgrads"):
        tile = kw["batch_tile"]
        pads = tuple(torch.cat([x, torch.zeros(tile, x.shape[1])]) for x in latents)
        out[1] = plain(params, pads, torch.cat([target, torch.zeros(tile, target.shape[1])]),
                       seed, **kw)[1]
    return tuple(out)


def bias_dropped(params, latents, target, seed, **kw):
    cut = [dict(p) for p in params]
    cut[2] = dict(cut[2], b=torch.zeros_like(cut[2]["b"]))
    return plain(cut, latents, target, seed, **kw)


def faulty_run(name, kw):
    if name == "lr * (1 + 1e-3)":
        return lambda *a, **k: plain(*a, **dict(k, lr=k["lr"] * (1 + 1e-3),
                                                warm_lr=k["warm_lr"] * (1 + 1e-3)))
    if name == "one Langevin step fewer":
        return one_step_fewer
    if name == "one tile's seed + 1":
        return patched_run("_noise_index", other_tile_seed)
    if name == "draws 2p and 2p+1 swapped":
        return patched_run("box_muller", lambda saved: lambda a, b: saved(b, a))
    if name == "one row's update skipped for one step":
        return cases.stale_run(plain, chain, B, 5, kw["warm_T"] + 15, kw["warm_T"])
    if name == "one layer's bias dropped":
        return bias_dropped
    if name == "pad rows added into a gradient sum":
        return pad_rows_in_gradients
    return patched_run("_chain_args", cases.no_bias_correction)


FAULTS = ("lr * (1 + 1e-3)", "one Langevin step fewer", "one tile's seed + 1",
          "draws 2p and 2p+1 swapped", "one row's update skipped for one step",
          "one layer's bias dropped", "pad rows added into a gradient sum",
          "Adam's bias correction off")


@pytest.mark.parametrize("fault", FAULTS)
def test_an_injected_fault_fails_the_step_rule(fault, sincos_err):
    inputs, kw = inputs_of(FAULT_CONFIG, 0)
    v = sr.check(faulty_run(fault, kw), inputs, kw, sincos_err=sincos_err)
    assert not v["ok"], sr.verdict_text(v)


@pytest.mark.parametrize("fault", [name for name, _ in smoke.ARG_FAULTS])
def test_the_smokes_argument_faults_fail_the_step_rule(fault, sincos_err):
    change = dict(smoke.ARG_FAULTS)[fault]
    params, latents, target = case(5)
    inputs = (params, latents, target, 11)

    def run(p, lat, t, seed, **kw):
        kw_f, seed_f = change(kw, seed)
        return plain(p, lat, t, seed_f, **kw_f)
    v = sr.check(run, inputs, ARG_KW, sincos_err=sincos_err)
    assert not v["ok"], sr.verdict_text(v)
    assert sr.check(plain, inputs, ARG_KW, sincos_err=sincos_err)["ok"]


def grad_case(config):
    """The inputs and options of a configuration with gradient sums: the
    mse MCPC batch, the two-tile chain of the fault catalogue, or the PC mse
    batch (the last Adam step's gradients)."""
    if config == "mse MCPC batch":
        params, latents, target = case(5)
        return (params, latents, target, 11), ARG_KW
    if config == "PC mse batch":
        act, kw = SKIP_CONFIGS[config]
        params, latents, target = case(21, act, batch=8)
        return (params, latents, target, 3), dict(kw, activation=act)
    return inputs_of(config, 0)


@pytest.mark.parametrize("fault", [name for name, _ in smoke.GRAD_FAULTS])
@pytest.mark.parametrize("config", ["mse MCPC batch", FAULT_CONFIG, "PC mse batch"])
def test_a_fault_of_the_gradient_sums_alone_fails(config, fault, sincos_err):
    """Injected into the chain's output (``grads_changed``, as the smoke
    injects it into the kernel's): it fails the step rule at these widths,
    and the smoke's gradient check (``grad_hold``), which the chain itself
    passes."""
    inputs, kw = grad_case(config)
    cap = sr.capture(plain, inputs, kw)
    v = sr.hold(cap, inputs, kw, sincos_err=sincos_err)
    assert v["ok"] and not smoke.grad_hold(config, v, cap.held["pgrads"])[1]
    faulty = sr.grads_changed(cap, dict(smoke.GRAD_FAULTS)[fault])
    w = sr.hold(faulty, inputs, kw, sincos_err=sincos_err)
    assert not w["ok"] and not w["parts"]["pgrads"]["ok"], sr.verdict_text(w)
    assert smoke.grad_hold(config, w, faulty.held["pgrads"])[1]


def quiet_and_busy_rows(inputs, kw):
    """The rows where the plain version and its products taken in float64
    end nearest to and furthest from each other."""
    ends = [torch.cat(run(*inputs, **kw)[0][:3], dim=1) for run in (plain, float64_products)]
    apart = (ends[0] - ends[1]).abs().amax(dim=1)
    return {"quiet": int(apart.argmin()), "busy": int(apart.argmax())}


@pytest.mark.parametrize("where", ["quiet", "busy"])
@pytest.mark.parametrize("config", sorted(SKIP_CONFIGS))
def test_one_row_skipped_fails_the_step_rule(config, where, sincos_err):
    """Made by the chain (``stale_row``) and injected into the captured
    output (``skip_row``, as the smoke injects it into the kernel's)."""
    act, kw = SKIP_CONFIGS[config]
    params, latents, target = case(21, act, loss=kw.get("loss", "bernoulli"), batch=8)
    kw = dict(kw, activation=act)
    inputs = (params, latents, target, 3)
    row = quiet_and_busy_rows(inputs, kw)[where]
    step = kw["warm_T"] // 2
    made = sr.check(cases.stale_run(plain, chain, 8, row, step, kw["warm_T"]), inputs, kw,
                    sincos_err=sincos_err)
    assert not made["ok"], sr.verdict_text(made)
    cap = sr.capture(plain, inputs, kw)
    assert sr.hold(cap, inputs, kw, sincos_err=sincos_err)["ok"]
    injected = sr.hold(sr.skip_row(cap, 0, step, row), inputs, kw, sincos_err=sincos_err)
    assert not injected["ok"], sr.verdict_text(injected)
    assert injected["parts"]["warm steps"]["at"].startswith(f"step {step}")


# -------------------------------------------------- the parameters' step


def test_the_parameters_adam_step_is_held_from_the_chains_own_gradients():
    from montecarlopredictivecoding_tpu_torch.core.optim import OptimizerSpec, apply_updates

    params, latents, target = case(6)
    grads = plain(params, latents, target, 1, **ARG_KW)[1]
    scale = (ARG_KW["T"] - ARG_KW["mixing"]) * B
    spec = OptimizerSpec("adam", lr=0.01)
    opt = spec.make()
    updates, _ = opt.update(tuple({k: v / scale for k, v in g.items()} for g in grads),
                            opt.init(params), params)
    stepped = apply_updates(params, updates)
    held = sr.param_hold(params, stepped, grads, scale, spec.lr, spec.betas, spec.eps)
    assert held["ok"] and 0.0 < held["ratio"] <= 1.0, held
    wrong = tuple({k: v.clone() for k, v in p.items()} for p in stepped)
    wrong[2]["w"][3, 4] += 0.01 * spec.lr
    assert not sr.param_hold(params, wrong, grads, scale, spec.lr, spec.betas, spec.eps)["ok"]
