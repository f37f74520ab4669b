"""The inference-learning engine: T-step predictive-coding inference as a
Python loop over steps, with autograd for the gradients.

The JAX package runs each schedule segment as one ``lax.scan``; here each
segment is a loop, and the semantics are the same:

* one objective evaluation per step: ``overall = loss + c * Σ energies
  (+ loss_x + loss_inputs)``;
* x-step at steps in ``update_x_at`` using only the current step's gradient;
* parameter grads accumulate across *every* step since the last zero event
  (zero events: update steps outside the accumulation window; the first
  accumulation step), and the parameter step divides by
  ``len(accumulate_p_at) * batch_size`` (or ``batch_size``);
* dynamic x-lr: multiply by ``x_lr_discount`` if overall did not decrease
  w.r.t. the previous step, by ``x_lr_amplifier`` otherwise, after each
  x-step from t>=1;
* MCPC Langevin noise: after the deterministic x-step, add
  ``N(0, lr0 * var)`` to every latent, where ``lr0`` is the *initial* x
  learning rate, scaled by the current learning-rate scale; the normals come
  from the state's ``torch.Generator``;
* early stop: a predicate ``early_stop_fn(t=, loss=, energy=, overall=)``
  evaluated on the step's pre-update values; after it fires the chain
  freezes (updates, noise and grad accumulation stop), and the parameter
  update still applies when ``update_p_at_early_stop`` (the default);
* captures every ``capture_stride``-th step, anchored at the global step
  index (``t % capture_stride == 0``).

This is the general path; the trainer sends the hot configurations to the
fused chain (``ops.mcpc_chain``) instead.
"""

from __future__ import annotations

import dataclasses
import functools
import sys
import typing as tp

import torch

from .model import PCModel
from .modules import random_tensor
from .optim import OptimizerSpec, Transform, apply_updates, tree_leaves, tree_map, tree_unflatten
from .schedule import SchedulePlan, Segment

Tensor = torch.Tensor


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_scale(a, s):
    return tree_map(lambda x: x * s, a)


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


# -- static engine configuration ---------------------------------------------


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    plan: SchedulePlan
    optimizer_x: OptimizerSpec
    optimizer_p: tp.Optional[OptimizerSpec]
    energy_coefficient: float = 1.0
    x_lr_discount: float = 1.0
    x_lr_amplifier: float = 1.0
    langevin_var: tp.Optional[float] = None
    loss_fn: tp.Optional[tp.Callable] = None
    loss_x_fn: tp.Optional[tp.Callable] = None
    loss_inputs_fn: tp.Optional[tp.Callable] = None
    early_stop_fn: tp.Optional[tp.Callable] = None
    update_p_at_early_stop: bool = True
    optimize_inputs: bool = False
    capture_every_t: bool = True
    capture_outputs: bool = False
    capture_representations: bool = False
    capture_xs: bool = False
    capture_overall_elementwise: bool = False
    capture_stride: int = 1
    rep_index: int = 0

    @property
    def dynamic_x_lr(self) -> bool:
        return self.x_lr_discount < 1.0 or self.x_lr_amplifier > 1.0


class EngineState(tp.NamedTuple):
    """The state train_on_batch threads through the steps."""

    params: tp.Any
    latents: tp.Any
    opt_x_state: tp.Any
    opt_p_state: tp.Any
    lr_scale: Tensor  # 0-d float32
    generator: tp.Optional[torch.Generator]


def _objective(cfg: EngineConfig, model: PCModel):
    def objective(xs_tree, params, ext_inputs, loss_kwargs):
        latents = xs_tree["latents"]
        inputs = xs_tree["inputs"] if cfg.optimize_inputs else ext_inputs
        # loss_kwargs entries prefixed "energy__" go to the per-layer
        # energy_fns as additional inputs
        extra = {
            k[len("energy__"):]: v
            for k, v in loss_kwargs.items()
            if k.startswith("energy__")
        }
        loss_kwargs = {
            k: v for k, v in loss_kwargs.items() if not k.startswith("energy__")
        }
        res = model.apply(params, latents, inputs,
                          energy_fn_additional_inputs=extra or None)
        zero = torch.zeros((), dtype=latents[0].dtype, device=latents[0].device)
        energy = functools.reduce(torch.add, res.energies) if res.energies else zero
        parts = []
        loss = None
        if cfg.loss_fn is not None:
            loss = cfg.loss_fn(res.output, **loss_kwargs)
            parts.append(loss)
        parts.append(energy * cfg.energy_coefficient)
        if cfg.loss_x_fn is not None:
            parts.append(functools.reduce(
                torch.add, [torch.sum(cfg.loss_x_fn(x)) for x in latents]))
        if cfg.loss_inputs_fn is not None and cfg.optimize_inputs:
            parts.append(cfg.loss_inputs_fn(inputs))
        overall = functools.reduce(torch.add, parts)
        aux = {
            "loss": loss if loss is not None else zero,
            "energy": energy,
            "overall": overall,
        }
        if cfg.capture_outputs:
            aux["outputs"] = res.output
        if cfg.capture_overall_elementwise:
            e_pd = functools.reduce(torch.add, res.energies_per_datapoint)[:, 0]
            loss_elem = torch.zeros_like(e_pd)
            if cfg.loss_fn is not None:
                kw = dict(loss_kwargs)
                kw["_reduction"] = "none"
                loss_elem = torch.sum(cfg.loss_fn(res.output, **kw), dim=-1)
            aux["overall_elementwise"] = e_pd + loss_elem
        return overall, aux

    return objective


def _value_and_grads(objective, xs_tree, params, inputs, loss_kwargs,
                     with_params: bool):
    """``(overall, aux), g_x, g_p`` of one step; ``g_p`` None unless
    ``with_params``.  The leaves are detached copies, so the caller's
    tensors are never part of a graph."""
    x_leaves = [x.detach().requires_grad_(True) for x in tree_leaves(xs_tree)]
    xs = tree_unflatten(xs_tree, x_leaves)
    p_leaves = []
    if with_params:
        p_leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        params = tree_unflatten(params, p_leaves)
    with torch.enable_grad():
        overall, aux = objective(xs, params, inputs, loss_kwargs)
        grads = torch.autograd.grad(overall, x_leaves + p_leaves, allow_unused=True)
    grads = [torch.zeros_like(v) if g is None else g
             for v, g in zip(x_leaves + p_leaves, grads)]
    aux = tree_map(lambda t: t.detach(), aux)
    g_x = tree_unflatten(xs_tree, grads[: len(x_leaves)])
    g_p = tree_unflatten(params, grads[len(x_leaves):]) if with_params else None
    return (overall.detach(), aux), g_x, g_p


def _normal_like(x: Tensor, generator: tp.Optional[torch.Generator]) -> Tensor:
    """Standard normals shaped like ``x`` from ``generator``.  For a DTensor
    latent (``parallel/sharding.py``) every rank draws the whole tensor from
    its generator, in the same state on every rank, and keeps its shard, so
    the noise is the same whatever the mesh, as ``jax.random``'s is."""
    noise = random_tensor("normal", x.shape, generator, x.dtype, x.device)
    # no DTensor exists before its module is imported (it takes a second)
    dtensor = sys.modules.get("torch.distributed.tensor")
    if dtensor is not None and isinstance(x, dtensor.DTensor):
        noise = dtensor.distribute_tensor(noise, x.device_mesh, x.placements,
                                          src_data_rank=None)
    return noise


def _run_segment(
    cfg: EngineConfig,
    model: PCModel,
    seg: Segment,
    opt_x: Transform,
    params,
    carry: dict,
    ext_inputs,
    loss_kwargs,
    opt_p: tp.Optional[Transform] = None,
    batch_size: tp.Optional[int] = None,
):
    """Run one contiguous segment of steps; returns (carry, captured ys).

    For dense schedules (``seg.p_update_every_step``) the parameters and the
    parameter-optimizer state live in the carry and step every iteration
    (grads divided by the batch size)."""
    objective = _objective(cfg, model)
    dense_p = seg.p_update_every_step and opt_p is not None
    noise_std = (
        float(cfg.langevin_var * cfg.optimizer_x.lr) ** 0.5
        if cfg.langevin_var is not None
        else None
    )
    acc_set = set(cfg.plan.accumulate_p_at)
    do_any_x = seg.update_x_mask is None or any(seg.update_x_mask)
    ys_all: tp.List[dict] = []

    for i in range(seg.length):
        t = seg.start + i
        m_x = True if seg.update_x_mask is None else seg.update_x_mask[i]
        m_z = False if seg.p_zero_mask is None else seg.p_zero_mask[i]
        xs_tree = carry["xs_tree"]
        step_params = carry["params"] if dense_p else params
        (overall, aux), g_x, g_p = _value_and_grads(
            objective, xs_tree, step_params, ext_inputs, loss_kwargs,
            seg.with_p_grads or dense_p)

        active = not carry["stopped"]
        # early stop predicate, evaluated on this step's pre-update values;
        # updates at the stop step still run
        stop_now = False
        if cfg.early_stop_fn is not None and active:
            stop_now = bool(cfg.early_stop_fn(
                t=t, loss=aux["loss"], energy=aux["energy"], overall=overall))

        # -- x update --------------------------------------------------------
        lr_scale = carry["lr_scale"]
        if do_any_x and m_x and active:
            updates, new_sx = opt_x.update(g_x, carry["opt_x_state"], xs_tree)
            # the scale applies always, so set_x_lr takes effect
            updates = tree_scale(updates, lr_scale)
            xs_tree = apply_updates(xs_tree, updates)
            carry["opt_x_state"] = new_sx

        # -- dynamic x-lr (after the x step) ----------------------------------
        if cfg.dynamic_x_lr and do_any_x and t >= 1 and m_x and active:
            decreased = bool(overall < carry["prev_overall"])
            factor = cfg.x_lr_amplifier if decreased else cfg.x_lr_discount
            lr_scale = lr_scale * factor

        # -- Langevin noise ---------------------------------------------------
        if noise_std is not None and active:
            # the noise follows the current learning-rate scale (after this
            # step's annealing)
            std = noise_std * lr_scale
            latents = tuple(x + std * _normal_like(x, carry["generator"])
                            for x in xs_tree["latents"])
            xs_tree = dict(xs_tree, latents=latents)

        # -- dense in-loop parameter update -----------------------------------
        if dense_p:
            g_scaled = tree_scale(g_p, 1.0 / batch_size)
            p_updates, carry["opt_p_state"] = opt_p.update(
                g_scaled, carry["opt_p_state"], step_params)
            carry["params"] = apply_updates(step_params, p_updates)

        # -- parameter-grad accumulation --------------------------------------
        pgrad = carry.get("pgrad")
        if seg.with_p_grads and pgrad is not None and active:
            if cfg.early_stop_fn is not None:
                # the zero also fires at the stop step when the stop-update is
                # on and the step is outside the accumulation window
                m_z = m_z or (stop_now and cfg.update_p_at_early_stop
                              and t not in acc_set)
            if m_z:
                pgrad = tree_zeros_like(pgrad)
            carry["pgrad"] = tree_add(pgrad, g_p)

        ys = {
            "loss": aux["loss"],
            "energy": aux["energy"],
            "overall": overall,
            "x_lr_scale": lr_scale,
        }
        if cfg.capture_outputs:
            ys["outputs"] = aux["outputs"]
        if cfg.capture_representations:
            ys["representations"] = carry["xs_tree"]["latents"][cfg.rep_index]
        if cfg.capture_xs:
            ys["xs"] = carry["xs_tree"]["latents"]
        if cfg.capture_overall_elementwise:
            ys["overall_elementwise"] = aux["overall_elementwise"]
        if t % cfg.capture_stride == 0:
            ys_all.append(ys)

        carry["xs_tree"] = xs_tree
        carry["lr_scale"] = lr_scale
        carry["prev_overall"] = overall
        if stop_now:
            carry["stopped"] = True
            if carry["stop_t"] < 0:
                carry["stop_t"] = t
    return carry, ys_all


def _stack(ys_all: tp.List[dict]) -> dict:
    """The captured steps' ys stacked along a leading time axis."""
    if not ys_all:
        return {}
    return tree_map(lambda *parts: torch.stack(parts), ys_all[0], *ys_all[1:])


def build_train_on_batch(model: PCModel, cfg: EngineConfig):
    """Build the train_on_batch function for a static config.

    Returns a function
        fn(state: EngineState, inputs, loss_kwargs) ->
            (EngineState, results dict)
    """
    opt_x = cfg.optimizer_x.make()
    opt_p = cfg.optimizer_p.make() if cfg.optimizer_p is not None else None
    needs_pgrad = any(s.with_p_grads for s in cfg.plan.segments) and opt_p is not None

    @torch.no_grad()
    def fn(state: EngineState, inputs, loss_kwargs):
        params = state.params
        xs_tree = {"latents": tuple(state.latents)}
        if cfg.optimize_inputs:
            xs_tree["inputs"] = inputs

        carry = {
            "xs_tree": xs_tree,
            "opt_x_state": state.opt_x_state,
            "lr_scale": state.lr_scale,
            "prev_overall": torch.zeros((), dtype=inputs.dtype, device=inputs.device),
            "generator": state.generator,
            "stopped": False,
            "stop_t": -1,
        }
        if needs_pgrad:
            carry["pgrad"] = tree_zeros_like(params)

        batch_size = inputs.shape[0]
        divisor = float(cfg.plan.p_divisor_steps * batch_size)
        opt_p_state = state.opt_p_state
        p_done = False

        ys_all: tp.List[dict] = []
        for seg in cfg.plan.segments:
            if seg.p_update_every_step and opt_p is not None:
                carry["params"] = params
                carry["opt_p_state"] = opt_p_state
                carry, ys = _run_segment(
                    cfg, model, seg, opt_x, params, carry, inputs,
                    loss_kwargs, opt_p=opt_p, batch_size=batch_size,
                )
                params = carry.pop("params")
                opt_p_state = carry.pop("opt_p_state")
            else:
                carry, ys = _run_segment(
                    cfg, model, seg, opt_x, params, carry, inputs, loss_kwargs)
            ys_all += ys

            if seg.p_update_at_end and opt_p is not None:
                # divide grads by len(accumulate)*B (or B), then the step
                g = tree_scale(carry["pgrad"], 1.0 / divisor)
                ok = True
                if cfg.early_stop_fn is not None:
                    ok = (not carry["stopped"]) or (cfg.update_p_at_early_stop
                                                    and not p_done)
                if ok:
                    updates, opt_p_state = opt_p.update(g, opt_p_state, params)
                    params = apply_updates(params, updates)
                    p_done = p_done or carry["stopped"]

        results = _stack(ys_all)
        results["stop_t"] = torch.tensor(carry["stop_t"], dtype=torch.int32)

        new_state = EngineState(
            params=params,
            latents=carry["xs_tree"]["latents"],
            opt_x_state=carry["opt_x_state"],
            opt_p_state=opt_p_state,
            lr_scale=carry["lr_scale"],
            generator=carry["generator"],
        )
        if cfg.optimize_inputs:
            results["optimized_inputs"] = carry["xs_tree"]["inputs"]
        return new_state, results

    return fn
