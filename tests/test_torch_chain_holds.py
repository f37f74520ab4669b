"""``chip_smoke.py``'s row rule for chains that amplify rounding, on the CPU.

The smoke holds a kernel's long chains to the plain version run in float64
row by row (``row_hold``; the rule's block in ``chip_smoke.py`` says how),
setting a row aside only where the plain version's witnesses (the same
function with other f32 rounding) part there.  Here the plain version
stands in for the kernel, at small widths:

- a catalogue of faults injected into the plain version must each fail
  the row rule, and every fault the old largest-element rule fails must
  fail the row rule too;
- other correct f32 orders (the products' sums split in halves, or taken
  in float64 and rounded once, and the latents started one ulp away by
  another draw than the witnesses') pass it on every draw tried;
- a built case where a latent lands within an ulp of relu's kink after
  one step: there another correct order takes the other side of the kink,
  the old rule fails it and the row rule passes it;
- the witnesses' stacked call gives each copy its own rows' noise, and
  their summed call each copy's own sums;
- the parameters' Adam step sets aside only the entries whose sign a
  correct order turns.
"""

import importlib
import pathlib
import sys

import pytest
import torch

import montecarlopredictivecoding_tpu_torch as mt

torch.set_num_threads(1)

ROOT = str(pathlib.Path(__file__).resolve().parents[1])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
smoke = importlib.import_module("chip_smoke")
sys.path.insert(0, str(pathlib.Path(ROOT) / "scripts"))
cases = importlib.import_module("rule_cases")
chain = importlib.import_module("montecarlopredictivecoding_tpu_torch.ops.mcpc_chain")

SEED = 7
# the fault catalogue's chain: every option a fault can reach (an Adam warm
# phase handing its moments out, noisy Langevin steps, two batch tiles,
# every step captured, the gradients of the last 10 steps)
DIMS, B, TILE = (4, 16, 16, 32), 16, 8
FAULT_KW = dict(warm_T=20, warm_lr=0.1, T=30, lr=0.03, noise_var=2.0, batch_tile=TILE,
                capture_stride=1, return_scalars=True, with_pgrads=True, mixing=20,
                emit_warm_opt_state=True)
STALE_ROW, STALE_STEP = 5, FAULT_KW["warm_T"] + 15
# the draws on which other correct orders must pass: a longer chain
DRAW_DIMS, DRAW_B, DRAWS = (4, 16, 16, 32), 32, range(6)
DRAW_KW = dict(warm_T=50, warm_lr=0.1, T=150, lr=0.03, noise_var=2.0, capture_stride=1,
               return_scalars=True, emit_warm_opt_state=True)
# the kink: wide enough products that their order shows in the last bit
KINK_DIMS, KINK_B, KINK_ROW, KINK_COL = (16, 64, 64, 32), 8, 1, 24
KINK_X = 0.0439293198287487  # x1[1, 24]: one SGD step at lr 0.1 lands it on relu's kink
KINK_KW = dict(T=60, lr=0.1, noise_var=None, return_scalars=True, capture_stride=1)


def case(dims, batch, seed):
    """Random parameters, fed-forward latents and a binary target."""
    g = torch.Generator().manual_seed(seed)
    model = mt.make_mlp_model(*dims)
    params = model.init(g, device="cpu")
    latents = model.init_latents(params, torch.zeros(batch, dims[0]), g)
    target = (torch.rand(batch, dims[3], generator=g) > 0.5).float()
    return params, latents, target


def plain(params, latents, target, seed=SEED, **kw):
    return chain.mcpc_chain_reference(params, latents, target, seed, **kw)


def one_step_fewer(params, latents, target):
    """T - 1 Langevin steps, returned in the full chain's shapes: the last
    capture is the state after T - 1 steps, the last scalar row repeated."""
    out = list(plain(params, latents, target, **dict(FAULT_KW, T=FAULT_KW["T"] - 1)))
    parts = smoke.option_parts(tuple(out), FAULT_KW)
    last = chain._pack_aligned(parts["latents"], DIMS[:3])
    out[2] = torch.cat([parts["traj"], last[None]])
    out[3] = {k: torch.cat([v[:-1], v[-2:]]) for k, v in parts["scalars"].items()}
    return tuple(out)


def other_tile_seed(saved):
    def index(c, batch, device):
        idx, seeds = saved(c, batch, device)
        return idx, seeds + (torch.arange(batch, device=device) >= c.tile)[:, None]
    return index


def pad_rows_in_gradients(params, latents, target):
    """The chain of the batch, its gradients summed over a tile of pad rows
    too (zero latents and target, evolving with the rest)."""
    pads = tuple(torch.cat([x, torch.zeros(TILE, x.shape[1])]) for x in latents)
    padded = plain(params, pads, torch.cat([target, torch.zeros(TILE, target.shape[1])]),
                   **FAULT_KW)
    out = list(plain(params, latents, target, **FAULT_KW))
    out[1] = padded[1]
    return tuple(out)


def bias_dropped(params, latents, target):
    cut = [dict(p) for p in params]
    cut[2] = dict(cut[2], b=torch.zeros_like(cut[2]["b"]))
    return plain(cut, latents, target, **FAULT_KW)


def run_faulty(name, params, latents, target):
    """The plain version with one fault injected."""
    if name == "lr * (1 + 1e-3)":
        return plain(params, latents, target, **dict(
            FAULT_KW, lr=FAULT_KW["lr"] * (1 + 1e-3), warm_lr=FAULT_KW["warm_lr"] * (1 + 1e-3)))
    if name == "one Langevin step fewer":
        return one_step_fewer(params, latents, target)
    if name == "one layer's bias dropped":
        return bias_dropped(params, latents, target)
    if name == "pad rows added into a gradient sum":
        return pad_rows_in_gradients(params, latents, target)
    fault = {"one tile's seed + 1": ("_noise_index", other_tile_seed),
             "draws 2p and 2p+1 swapped": ("box_muller", lambda saved: lambda a, b: saved(b, a)),
             "one row's update skipped for one step": (
                 "activation_fn", cases.stale_row(B, STALE_ROW, STALE_STEP)),
             "Adam's bias correction off": ("_chain_args", cases.no_bias_correction)}[name]
    with cases.patched(chain, *fault):
        return plain(params, latents, target, **FAULT_KW)


FAULTS = ("lr * (1 + 1e-3)", "one Langevin step fewer", "one tile's seed + 1",
          "draws 2p and 2p+1 swapped", "one row's update skipped for one step",
          "one layer's bias dropped", "pad rows added into a gradient sum",
          "Adam's bias correction off")


@pytest.fixture(scope="module")
def fault_case():
    params, latents, target = case(DIMS, B, SEED)
    ref = plain(params, latents, target, **FAULT_KW)
    ref64 = plain(*smoke.to_double(params, latents, target), **FAULT_KW)
    return (params, latents, target), ref, ref64


@pytest.mark.parametrize("fault", FAULTS)
def test_an_injected_fault_fails_the_row_rule(fault, fault_case):
    inputs, ref, ref64 = fault_case
    got = run_faulty(fault, *inputs)
    text, failed, old_failed = smoke.row_hold(
        torch, chain, fault, got, ref, ref64,
        smoke.Witnesses(torch, chain, *inputs, SEED, FAULT_KW), FAULT_KW, DIMS)
    verdicts = (f"old rule {'FAILS' if old_failed else 'holds'}, row rule "
                f"{'FAILS' if failed else 'holds'}: {text}")
    assert failed, verdicts
    assert not old_failed or failed, verdicts


@pytest.mark.parametrize("draw", DRAWS)
def test_other_correct_orders_pass_the_row_rule(draw):
    params, latents, target = case(DRAW_DIMS, DRAW_B, 100 + draw)
    ref = plain(params, latents, target, draw, **DRAW_KW)
    ref64 = plain(*smoke.to_double(params, latents, target), draw, **DRAW_KW)
    witnesses = smoke.Witnesses(torch, chain, params, latents, target, draw, DRAW_KW)
    others = {}
    for how in ("halves", "float64"):
        with cases.other_order(how):
            others[how] = plain(params, latents, target, draw, **DRAW_KW)
    others["one ulp off"] = plain(params, cases.one_ulp_off(latents, 900 + draw), target, draw,
                                  **DRAW_KW)
    for how, got in others.items():
        text, failed, _ = smoke.row_hold(torch, chain, how, got, ref, ref64, witnesses,
                                         DRAW_KW, DRAW_DIMS)
        assert not failed, f"draw {draw}, {how}: {text}"


def kink_case():
    params, latents, target = case(KINK_DIMS, KINK_B, 4)
    latents[1][KINK_ROW, KINK_COL] = KINK_X
    return params, latents, target


def test_a_latent_at_relus_kink_is_set_aside_not_failed():
    """x1[1, 24] is the f32 value whose first SGD step lands within an ulp
    of 0.  The plain f32 version and float64 leave it at or below 0 (relu'
    = 0); the products summed in two halves leave it above, and so does a
    witness.  From there that row follows another path: the old rule fails
    that correct order, the row rule sets the row aside and passes it."""
    params, latents, target = kink_case()
    one = dict(T=1, lr=KINK_KW["lr"], noise_var=None)
    at = (KINK_ROW, KINK_COL)
    first = float(plain(params, latents, target, 0, **one)[0][1][at])
    first64 = float(plain(*smoke.to_double(params, latents, target), 0, **one)[0][1][at])
    with cases.other_order("halves"):
        first_h = float(plain(params, latents, target, 0, **one)[0][1][at])
    assert first <= 0.0 and first64 <= 0.0 < first_h
    assert max(abs(first), abs(first_h)) <= 2 * torch.finfo(torch.float32).eps, (first, first_h)
    assert any(float(w["latents"][1][at]) > 0.0 for w in smoke.Witnesses(
        torch, chain, params, latents, target, 0, one).stacked())

    ref = plain(params, latents, target, 0, **KINK_KW)
    ref64 = plain(*smoke.to_double(params, latents, target), 0, **KINK_KW)
    with cases.other_order("halves"):
        got = plain(params, latents, target, 0, **KINK_KW)
    text, failed, old_failed = smoke.row_hold(
        torch, chain, "kink", got, ref, ref64,
        smoke.Witnesses(torch, chain, params, latents, target, 0, KINK_KW), KINK_KW, KINK_DIMS)
    assert old_failed, text
    assert not failed, text
    assert "set aside 1" in text


@pytest.mark.parametrize("kw, output_pc", [
    (dict(warm_T=5, warm_lr=0.1, T=12, lr=0.03, noise_var=2.0, batch_tile=8, capture_stride=1,
          return_scalars=True, emit_warm_opt_state=True), False),
    (dict(T=12, lr=0.03, noise_var=2.0, packed=False), False),
    (dict(T=12, lr=0.05, noise_var=2.0, output_var=0.5, loss="none", capture_stride=3,
          return_scalars=True), True),
])
def test_stacked_witnesses_draw_each_copys_own_noise(kw, output_pc):
    """Without the jitter the stacked call's first copy (products summed in
    reverse over k) is a separate run with those products bit for bit, so
    every copy drew its own rows' noise; with it every copy ends within
    rounding of the plain version."""
    g = torch.Generator().manual_seed(3)
    model = mt.make_mlp_model(*DIMS, output_pc=mt.PC(energy_fn=mt.scaled_gaussian_energy(0.5))
                              if output_pc else None)
    params = model.init(g, device="cpu")
    latents = model.init_latents(params, torch.zeros(B, DIMS[0]), g)
    target = None
    if output_pc:
        latents = smoke.off_prediction(torch, latents, g)
    else:
        target = (torch.rand(B, DIMS[3], generator=g) > 0.5).float()
    args = (torch, chain, params, latents, target, SEED, kw)
    unjittered = smoke.Witnesses(*args, ulps=0).stacked()
    with smoke.jittered_rounding(torch, chain, B, SEED, params, ulps=0):
        alone = smoke.option_parts(plain(params, latents, target, **kw), kw)
    assert smoke.bits_equal(torch, unjittered[0]["latents"], alone["latents"])
    ref = smoke.option_parts(plain(params, latents, target, **kw), kw)
    for copy in smoke.Witnesses(*args).stacked():
        for part in ("latents", "traj", "traj3", "moments"):
            if part in copy:
                far = float(smoke.unit_distances(torch, part, copy[part], ref[part])[0].max())
                assert far <= 1e-5, (part, far)


@pytest.mark.parametrize("kw", [
    dict(warm_T=5, warm_lr=0.1, T=12, lr=0.03, noise_var=2.0, batch_tile=8, with_pgrads=True,
         mixing=4, return_scalars=True),
    dict(warm_T=8, warm_lr=0.1, T=0, lr=0.1, noise_var=None, with_pgrads=True,
         warm_pgrads=True, return_scalars=True, scalar_stride=3),
    dict(T=12, lr=0.03, noise_var=2.0, batch_tile=8, with_pgrads=True, mixing=4,
         return_scalars=True, capture_stride=2),
    dict(T=12, lr=0.03, noise_var=2.0, packed=False, with_pgrads=True, mixing=4),
])
def test_summed_witnesses_take_each_copys_sums_apart(kw):
    """The witnesses of the batch sums (gradients, uncaptured scalars): one
    stacked call whose sums ``sums_apart`` takes copy by copy.  Without
    the jitter each copy's gradients and scalars are a separate run's with
    its products summed in reverse, within rounding of the batched sums
    (2e-6 of each gradient tensor's largest entry, 1e-6 relative for a
    scalar)."""
    params, latents, target = case(DIMS, B, SEED)
    witnesses = smoke.Witnesses(torch, chain, params, latents, target, SEED, kw, ulps=0)
    copies = witnesses.summed()
    assert len(copies) == smoke.SUM_COPIES
    alone_kw = {k: v for k, v in kw.items() if k != "capture_stride"}
    with smoke.jittered_rounding(torch, chain, B, SEED, params, ulps=0):
        alone = smoke.option_parts(plain(params, latents, target, **alone_kw), alone_kw)
    for copy in copies:
        assert smoke.grad_rel(copy["pgrads"], alone["pgrads"]) <= 2e-6
        if kw.get("return_scalars") and "capture_stride" not in kw:
            assert copy["scalars"]["loss"].shape == alone["scalars"]["loss"].shape
            assert smoke.scalar_rel(copy["scalars"], alone["scalars"]) <= 1e-6


# ------------------------------------------------------------- the old rule
# The old largest-element rule, printed beside every verdict: each part's old
# error function of PART_RULES is its largest element distance from the
# reference.

@pytest.mark.parametrize("part", [p for p, _, _ in smoke.PART_RULES if p != "traj3"])
def test_the_old_rule_is_the_largest_element_distance(part, fault_case):
    inputs, ref, ref64 = fault_case
    got = run_faulty("lr * (1 + 1e-3)", *inputs)
    gp, rp, bp = (smoke.option_parts(o, FAULT_KW) for o in (got, ref, ref64))
    err = {p: e for p, _, e in smoke.PART_RULES}[part]
    a, c = ([gp[part]], [bp[part]]) if part == "traj" else (gp[part], bp[part])
    largest = float(smoke.unit_distances(torch, part, gp[part], bp[part])[1].max())
    assert err(a, c) == pytest.approx(largest, rel=1e-12, abs=0.0)


# ------------------------------------------------ the parameters' Adam step
@pytest.mark.parametrize("turned_by, passes", [
    ("a witness", True), ("plain f32", True), ("no correct order", False),
    ("no correct order given", False)])
def test_the_parameter_rule_sets_aside_only_entries_a_correct_order_turns(turned_by, passes):
    """Adam's first step is lr * sign(g): a kernel whose gradient takes the
    other sign on one clear entry (0.5% of its tensor's largest) sits 2 lr
    from the float64 step there.  The entry is set aside only where a
    correct order's gradient (plain f32 or a witness) turns its sign too;
    elsewhere the rule fails it."""
    from montecarlopredictivecoding_tpu_torch.core.optim import OptimizerSpec, apply_updates

    lr, g = 0.01, torch.Generator().manual_seed(5)
    p0 = tuple({"w": torch.randn(4, 3, generator=g, dtype=torch.float64),
                "b": torch.randn(3, generator=g, dtype=torch.float64)} for _ in range(2))
    g64 = tuple({k: torch.randn(v.shape, generator=g, dtype=torch.float64) for k, v in p.items()}
                for p in p0)
    g64[1]["w"][2, 1] = 0.005 * float(g64[1]["w"].abs().max())
    kernel = tuple({k: v.clone() for k, v in p.items()} for p in g64)
    kernel[1]["w"][2, 1] = -kernel[1]["w"][2, 1]
    plain_f32 = tuple({k: v.clone() for k, v in p.items()} for p in g64)
    witnesses = [tuple({k: v.clone() for k, v in p.items()} for p in g64) for _ in range(3)]
    if turned_by == "a witness":
        witnesses[1][1]["w"][2, 1] = -witnesses[1][1]["w"][2, 1]
    elif turned_by == "plain f32":
        plain_f32[1]["w"][2, 1] = -plain_f32[1]["w"][2, 1]
    opt = OptimizerSpec("adam", lr=lr).make()
    updates, _ = opt.update(kernel, opt.init(p0), p0)
    stepped = apply_updates(p0, updates)
    orders = [] if turned_by == "no correct order given" else [plain_f32] + witnesses
    worst, n_clear, total, n_aside = smoke.param_rule(torch, opt, apply_updates, p0, stepped,
                                                      g64, 1.0, orders)
    assert total == 30 and n_clear == 30
    assert n_aside == (1 if passes else 0)
    assert (worst <= smoke.P3_PARAM_ATOL) == passes
    assert passes or worst == pytest.approx(2 * lr, rel=1e-4)
