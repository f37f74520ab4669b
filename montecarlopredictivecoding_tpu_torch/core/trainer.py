"""PCTrainer: the trainer API over the step engine and the fused chain.

Model parameters and latents live in a shared :class:`GenerativeModel`
handle, so a PC trainer and an MCPC trainer can hand latents to each other
(the warm-start-then-sample pattern).  Every ``train_on_batch`` call either
runs the fused chain, ``ops.mcpc_chain`` (the hand-written kernel on CUDA
tensors, its plain version on CPU tensors), when the configuration maps onto
it, or the general step engine (:mod:`.engine`) otherwise, warning once per
reason when the chain was expected.

The MCPC Langevin noise is the :class:`LangevinStep` config (or the
``langevin_var=`` shorthand).
"""

from __future__ import annotations

import dataclasses
import functools
import typing as tp
import warnings

import torch

from . import losses as L
from .engine import EngineConfig, EngineState, build_train_on_batch, tree_scale
from .model import PCModel
from .modules import activation_fn
from .optim import OptimizerSpec, adam_moments, adam_state, apply_updates
from .schedule import build_plan
from ..utils.observability import slow_down_warning, span

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class LangevinStep:
    """After each deterministic x-step, add Gaussian noise ``N(0, lr0 * var)``
    to every latent.  ``var=2.0`` yields exact unadjusted Langevin dynamics
    with stationary distribution ∝ exp(-E)."""

    var: float = 2.0


class GenerativeModel:
    """Holds a PCModel spec plus its explicit state (params, latents, RNG).

    Plays the role of the reference's stateful ``nn.Sequential`` model that
    both trainers share.  ``generator`` is a ``torch.Generator`` or an int
    seed for a new CPU generator; parameters and latents are drawn from it
    in call order.
    """

    def __init__(
        self,
        model: PCModel,
        generator: tp.Union[torch.Generator, int],
        params=None,
        dtype: torch.dtype = torch.float32,
        device="cuda",
    ):
        self.model = model
        if isinstance(generator, int):
            generator = torch.Generator().manual_seed(generator)
        self.generator = generator
        if params is None:
            params = model.init(generator, dtype, device)
        self.params = params
        self.latents: tp.Optional[tuple] = None

    # reference-parity helpers ------------------------------------------------

    def get_model_xs(self):
        """All latent value nodes."""
        return self.latents

    def get_x(self, index: int = 0):
        """Latent of the index-th PC layer."""
        return self.latents[index]

    def predict(self, inputs: torch.Tensor) -> torch.Tensor:
        """Eval-mode forward (PC layers are identity)."""
        return self.model.predict(self.params, inputs)

    def sample_latents(self, inputs: torch.Tensor,
                       generator: tp.Optional[torch.Generator] = None):
        self.latents = self.model.init_latents(
            self.params, inputs, generator or self.generator, self.latents
        )
        return self.latents

    def ancestral_sample(self, num_samples: int,
                         generator: tp.Optional[torch.Generator] = None):
        return self.model.ancestral_sample(
            self.params, generator or self.generator, num_samples
        )


@functools.lru_cache(maxsize=256)
def _static_loss_partial(loss_fn, static_items: tuple):
    """Stable-identity partial binding static kwargs into a loss fn, so the
    engine's cache keyed on the callable keeps hitting across calls."""
    return functools.partial(loss_fn, **dict(static_items))


def _last_only_results(results: dict) -> dict:
    """``is_return_results_every_t=False``: keep only the last time step of
    every time-leading result, alike on the engine and kernel paths."""

    def last_only(v):
        if isinstance(v, tuple):
            return tuple(last_only(x) for x in v)
        if hasattr(v, "ndim") and v.ndim >= 1:
            return v[-1:]
        return v

    # 'optimized_inputs' is [B, D], batch-leading, not time-leading
    not_time_leading = {
        k: results.pop(k) for k in ("optimized_inputs",) if k in results
    }
    results = {k: last_only(v) for k, v in results.items()}
    results.update(not_time_leading)
    return results


class PCTrainer:
    """Inference-learning trainer.

    Args mirror the JAX package's ``PCTrainer``; optimizers are given as
    ``('sgd'|'adam'|'adamw', kwargs)`` in torch-kwarg style or as
    :class:`OptimizerSpec`.

    ``use_kernel``: ``"auto"`` (default) sends every configuration the fused
    chain covers to ``ops.mcpc_chain``, whatever the device; ``False`` sends
    everything to the engine.  ``use_kernel_bf16=True`` runs the chain with
    bf16 products (``mcpc_chain(..., bf16_matmul=True)``: bf16 operands,
    f32 sums, f32 state); ``"auto"`` (default) and ``False`` keep f32, as
    the JAX trainer's ``use_pallas_bf16`` does.  ``kernel_calls`` and
    ``engine_calls`` count the ``train_on_batch`` calls each path took, and
    ``kernel_param_updates`` the parameter updates the chain's path took.
    """

    def __init__(
        self,
        model: GenerativeModel,
        optimizer_x_fn="sgd",
        optimizer_x_kwargs: tp.Optional[dict] = None,
        x_lr_amplifier: float = 1.0,
        x_lr_discount: float = 1.0,
        loss_x_fn: tp.Optional[tp.Callable] = None,
        loss_inputs_fn: tp.Optional[tp.Callable] = None,
        optimizer_p_fn="adam",
        optimizer_p_kwargs: tp.Optional[dict] = None,
        T: int = 512,
        update_x_at="all",
        update_p_at="all",
        accumulate_p_at="never",
        energy_coefficient: float = 1.0,
        early_stop_fn: tp.Optional[tp.Callable] = None,
        update_p_at_early_stop: bool = True,
    ):
        if not isinstance(model, GenerativeModel):
            raise TypeError("PCTrainer expects a GenerativeModel handle")
        self.gen = model
        self.T = int(T)
        if self.T < self.gen.model.get_least_T():
            warnings.warn(
                f"T={self.T} is less than the recommended minimum "
                f"{self.gen.model.get_least_T()} (num_pc_layers + 1); "
                "errors may not fully propagate through the stack.",
                RuntimeWarning,
            )
        self.opt_x_spec = OptimizerSpec.from_torch_style(
            optimizer_x_fn, optimizer_x_kwargs or {"lr": 0.1}
        )
        self.opt_p_spec = (
            OptimizerSpec.from_torch_style(
                optimizer_p_fn, optimizer_p_kwargs or {"lr": 0.001}
            )
            if optimizer_p_fn is not None
            else None
        )
        update_p = update_p_at if self.opt_p_spec is not None else "never"
        self.plan = build_plan(
            self.T,
            update_x_at,
            update_p,
            accumulate_p_at,
            # with an early-stop predicate the update can fire at any step, so
            # parameter grads must stay live from t=0
            force_p_grads=early_stop_fn is not None,
        )
        self.x_lr_amplifier = float(x_lr_amplifier)
        self.x_lr_discount = float(x_lr_discount)
        self.loss_x_fn = loss_x_fn
        self.loss_inputs_fn = loss_inputs_fn
        self.energy_coefficient = float(energy_coefficient)
        self.early_stop_fn = early_stop_fn
        self.update_p_at_early_stop = bool(update_p_at_early_stop)

        # optimizer states held by the trainer (recreated when latents are
        # resampled)
        self._opt_x_state = None
        self._opt_p_state = None
        self._lr_scale = torch.ones(())
        self._lr_scale_host: tp.Optional[float] = 1.0
        self._fns: dict = {}
        self.use_kernel: tp.Union[str, bool] = "auto"
        self.use_kernel_bf16: tp.Union[str, bool] = "auto"
        self.kernel_calls = 0
        self.engine_calls = 0
        self.kernel_param_updates = 0
        # why the last dispatch that could have used the chain fell back to
        # the engine; warned once per reason
        self._kernel_fallback_reason: tp.Optional[tp.Tuple[str, str]] = None
        self._warned_fallbacks: set = set()

    # -- utility surface ------------------------------------------------------

    def get_model_xs(self):
        return self.gen.latents

    def get_model_xs_copy(self):
        """Detached copies of all latents."""
        return tuple(x.clone() for x in self.gen.latents)

    def get_model_representations(self, index: int = 0):
        """The first PC layer's latent."""
        return self.gen.latents[index]

    def get_is_model_has_pc_layers(self) -> bool:
        return self.gen.model.num_pc_layers > 0

    def get_model_pc_layers(self):
        """PC specs in stack order."""
        return self.gen.model.pc_layers

    def get_named_model_pc_layers(self):
        """(module-index, PC spec) pairs."""
        return tuple(
            (f"modules[{i}]", self.gen.model.modules[i])
            for i in self.gen.model.pc_indices
        )

    def get_energies(self, inputs=None, is_per_datapoint: bool = False):
        """Per-layer energies at the current latents.  ``inputs`` defaults to
        the zeros pseudo-input."""
        if inputs is None:
            first = self.gen.model.modules[self.gen.model.linear_indices[0]]
            x0 = self.gen.latents[0]
            inputs = torch.zeros((x0.shape[0], first.in_dim), dtype=x0.dtype,
                                 device=x0.device)
        with torch.no_grad():
            res = self.gen.model.apply(self.gen.params, self.gen.latents, inputs)
        return res.energies_per_datapoint if is_per_datapoint else res.energies

    def get_weights_norms_list(self):
        return [float(n) for n in self.get_weights_norms()]

    def set_x_lr(self, lr: float):
        """Set the effective x learning rate by adjusting the scale relative
        to the configured base lr."""
        self._lr_scale = torch.tensor(lr / self.opt_x_spec.lr, dtype=torch.float32)
        self._lr_scale_host = lr / self.opt_x_spec.lr

    def get_numparameters(self, exclude_first_linear: bool = False) -> int:
        return self.gen.model.num_parameters(self.gen.params, exclude_first_linear)

    def get_weights_norms(self):
        return self.gen.model.weight_norms(self.gen.params)

    def get_least_T(self) -> int:
        return self.gen.model.get_least_T()

    def get_x_lr(self) -> float:
        return float(self.opt_x_spec.lr * self._lr_scale)

    def recreate_optimizer_x(self):
        self._opt_x_state = None
        self._lr_scale = torch.ones(())
        self._lr_scale_host = 1.0  # host mirror (valid while dynamic lr is off)

    def recreate_optimizer_p(self):
        self._opt_p_state = None

    # -- the fused chain ------------------------------------------------------

    def _latent_layout(self):
        """Latent dims and their aligned packed layout ``(pads, offs, XW)``."""
        # imported here: ops' coverage rule reads core's module classes
        from ..ops.mcpc_chain import aligned_layout

        dims = [
            self.gen.model.modules[i].out_dim
            for i in self.gen.model.linear_indices[:-1]
        ]
        return dims, aligned_layout(dims)

    def _no_kernel(self, option: str, suggestion: str):
        """Record why this dispatch falls back to the engine."""
        self._kernel_fallback_reason = (option, suggestion)
        return None

    def _warn_kernel_fallback(self, device: torch.device) -> None:
        """Warn once per reason, where the chain was expected: with
        ``use_kernel=True``, or ``"auto"`` on a CUDA device."""
        if self._kernel_fallback_reason is None:
            return
        if not (self.use_kernel is True
                or (self.use_kernel == "auto" and device.type == "cuda")):
            return
        if self._kernel_fallback_reason in self._warned_fallbacks:
            return
        self._warned_fallbacks.add(self._kernel_fallback_reason)
        option, suggestion = self._kernel_fallback_reason
        slow_down_warning(
            "PCTrainer.train_on_batch",
            f"{option} (chain runs in the step engine, not the fused kernel)",
            suggestion,
        )

    def _kernel_eligible(
        self, cfg: EngineConfig, loss_fn, is_optimize_inputs, langevin_var,
        batch_size: int,
    ):
        """The fused chain covers the hot configurations over the canonical
        MLP, rule for rule as the JAX package's ``_pallas_eligible``:

        * 'langevin' mode: plain-SGD x-updates on every step, optional
          Langevin noise, parameter grads accumulated over a contiguous
          suffix window with a single update at the last step (the MCPC
          chain);
        * 'warm' mode: Adam x-updates on every step (the PC MAP descent),
          optionally emitting the final step's parameter gradients
          (update_p='last' PC training), resuming a live Adam state.

        Returns the dispatch dict, or None (the reason in
        ``_kernel_fallback_reason``)."""
        # imported here: ops' coverage rule reads core's module classes
        from ..ops.mcpc_chain import (
            _pick_batch_tile, model_activation, output_pc_var, supports_model)

        self._kernel_fallback_reason = None
        if self.use_kernel is False:
            return None
        model = self.gen.model
        activation = model_activation(model)
        output_var = None
        if activation is None or not supports_model(model, activation):
            output_var = output_pc_var(model)
            if activation is None or output_var is None:
                return self._no_kernel(
                    "a model topology outside the fused-kernel family",
                    "a relu/tanh Linear+PC stack (optional trailing PC)",
                )
        if batch_size > 1024 and _pick_batch_tile(batch_size) < 128:
            # no tile divisor: the noise seeds of such a batch cannot be cut
            # into tiles; the engine handles it in one pass
            return self._no_kernel(
                f"a batch size ({batch_size}) with no 128-lane tile divisor",
                "a multiple of 128",
            )
        if self.opt_x_spec.name == "sgd" and not self.opt_x_spec.momentum:
            mode = "langevin"
        elif self.opt_x_spec.name == "adam" and not self.opt_x_spec.weight_decay:
            mode = "warm"
        else:
            return self._no_kernel(
                f"optimizer_x_fn={self.opt_x_spec.name} with "
                "momentum/weight_decay",
                "plain sgd or adam",
            )
        if cfg.energy_coefficient != 1.0:
            # the chain hardcodes overall = loss + 1.0 * energy
            return self._no_kernel("energy_coefficient != 1.0", "1.0")
        if self._lr_scale_host is None or self._lr_scale_host <= 0.0:
            # a dynamic-annealing run left the live scale in the engine's
            # state only; the chain's lr can't fold an unknown scale
            return self._no_kernel(
                "set_x_lr after a dynamic-lr run (device-only scale)",
                "set_x_lr/recreate_optimizer_x to re-arm",
            )
        if cfg.dynamic_x_lr or cfg.early_stop_fn is not None:
            return self._no_kernel(
                "x_lr_discount/x_lr_amplifier or early_stop_fn",
                "1.0 / None",
            )
        if cfg.loss_x_fn is not None or cfg.loss_inputs_fn is not None or is_optimize_inputs:
            return self._no_kernel(
                "loss_x_fn / loss_inputs_fn / is_optimize_inputs",
                "None / False",
            )
        # 'outputs' captures are served from the latent trajectory
        wants_traj = (
            cfg.capture_representations or cfg.capture_xs or cfg.capture_outputs
        )
        if cfg.capture_overall_elementwise:
            return self._no_kernel("is_return_batchelement_loss", "False")
        scalar_stride = 0
        if cfg.capture_every_t and not wants_traj:
            # per-step loss/energy curves without trajectory captures: the
            # chain emits the scalar slots itself, at any chain length
            scalar_stride = max(int(cfg.capture_stride), 1)
        warm_cont = False
        if mode == "warm":
            if langevin_var is not None:
                return self._no_kernel(
                    "LangevinStep noise under an Adam x-optimizer",
                    "sgd for Langevin chains",
                )
            if self._opt_x_state is not None:
                # continuation call (no resample): the chain resumes the live
                # Adam moments and count
                if self._warm_moments() is None:
                    return self._no_kernel(
                        "a continuation with a non-plain-Adam optimizer-x "
                        "state",
                        "is_reset_optimizer_x_at_batch_start=True",
                    )
                warm_cont = True
        plan = cfg.plan
        if plan.update_x_at != tuple(range(plan.T)):
            return self._no_kernel("update_x_at != 'all'", "'all'")
        # static kwargs ('perc', '_reduction') arrive bound in a partial
        base_fn, static_kw = loss_fn, {}
        if isinstance(loss_fn, functools.partial):
            base_fn = loss_fn.func
            static_kw = dict(loss_fn.keywords)
        loss_name = None
        mask_perc = None
        if base_fn is L.bernoulli_fn:
            if static_kw.get("_reduction", "sum") == "sum":
                loss_name = "bernoulli"
        elif base_fn is L.fe_fn:
            loss_name = "gaussian"
        elif base_fn is L.bernoulli_fn_mask:
            loss_name = "bernoulli_mask"
            mask_perc = float(static_kw.get("perc", 0.5))
        elif base_fn is L.fe_fn_mask:
            loss_name = "gaussian_mask"
            mask_perc = float(static_kw.get("perc", 0.5))
        elif base_fn is L.zero_fn or loss_fn is None:
            loss_name = "none"
        if loss_name is None:
            return self._no_kernel(
                "an unsupported loss_fn",
                "fe_fn/bernoulli_fn (+_mask) or zero_fn",
            )
        if output_var is not None and loss_name != "none":
            # trailing-PC joint samplers are unclamped by construction
            return self._no_kernel(
                "a sensory loss on an output-PC joint sampler",
                "zero_fn",
            )
        cap = {}
        if wants_traj:
            cap = {
                "capture_stride": max(int(cfg.capture_stride), 1),
                "capture_xs": cfg.capture_xs,
                "capture_representations": cfg.capture_representations,
                "capture_outputs": cfg.capture_outputs,
            }
        elif scalar_stride:
            cap = {"scalar_stride": scalar_stride}
        base = {"loss": loss_name, "mode": mode, "activation": activation,
                "output_var": output_var, "mask_perc": mask_perc,
                "warm_cont": warm_cont}
        if not plan.update_p_at:
            return {**base, "with_pgrads": False, "mixing": 0, **cap}
        if plan.update_p_at != (plan.T - 1,):
            return self._no_kernel(
                "update_p_at other than 'last'/'never'", "'last' or 'never'"
            )
        if plan.accumulate_p_at:
            if mode == "warm":
                # warm-mode pgrads come from the last step only
                return self._no_kernel(
                    "accumulate_p_at under an Adam x-optimizer",
                    "'never' (last-step grads) or sgd",
                )
            acc = plan.accumulate_p_at
            if acc != tuple(range(acc[0], plan.T)):
                return self._no_kernel(
                    "a non-contiguous accumulate_p_at window",
                    "a contiguous suffix [mixing, T)",
                )
            mixing = acc[0]
        else:
            mixing = plan.T - 1
        return {**base, "with_pgrads": True, "mixing": mixing, **cap}

    def _warm_moments(self):
        """``(mu, nu, count)`` of the latents from the live optimizer-x
        state, or None unless it is a plain Adam state over exactly the
        current latents."""
        found = adam_moments(self._opt_x_state, {"latents": self.gen.latents})
        if found is None:
            return None
        mu, nu, count = found
        return mu["latents"], nu["latents"], count

    def _chain_seed(self, generator: torch.Generator) -> int:
        """The chain's noise seed, drawn from ``generator``."""
        return int(torch.randint(0, 2**31 - 1, (), generator=generator))

    def _run_kernel(self, dispatch, cfg, inputs, loss_fn_kwargs, langevin_var,
                    generator, chain_seed=None):
        # imported here: ops' coverage rule reads core's module classes
        from ..ops.mcpc_chain import mcpc_chain

        gen = self.gen
        seed = self._chain_seed(generator) if chain_seed is None else int(chain_seed)
        target = loss_fn_kwargs.get("_target")
        input_var = loss_fn_kwargs.get("_var") or 1.0
        stride = dispatch.get("capture_stride", 0)
        scalar_stride = dispatch.get("scalar_stride", 0)
        # set_x_lr folds into the chain's lr: SGD and Adam updates are linear
        # in lr, and the Langevin std is sqrt(lr0*var) * scale =
        # sqrt((lr0*scale) * (var*scale))
        scale = self._lr_scale_host
        lr_eff = self.opt_x_spec.lr * scale
        if langevin_var is not None:
            langevin_var = langevin_var * scale
        warm_cont = None
        if dispatch["mode"] == "warm":
            # the whole chain as Adam MAP descent (+ last-step pgrads); the
            # final moments come back so a continuation resumes them
            phase = dict(
                T=0, lr=lr_eff, noise_var=None, warm_T=self.T, warm_lr=lr_eff,
                warm_b1=self.opt_x_spec.betas[0],
                warm_b2=self.opt_x_spec.betas[1],
                warm_eps=self.opt_x_spec.eps,
                warm_pgrads=dispatch["with_pgrads"],
                emit_warm_opt_state=True,
            )
            if dispatch.get("warm_cont"):
                warm_cont = self._warm_moments()
                phase.update(warm_mu=warm_cont[0], warm_nu=warm_cont[1],
                             warm_count=warm_cont[2])
        else:
            phase = dict(T=self.T, lr=lr_eff, noise_var=langevin_var)
        output_pc = dispatch["output_var"] is not None
        # "auto" is f32, as in the JAX trainer: bf16 is an explicit opt-in
        bf16 = self.use_kernel_bf16 is True
        outs = list(mcpc_chain(
            gen.params, gen.latents, target, seed,
            loss=dispatch["loss"], input_var=float(input_var),
            mixing=dispatch["mixing"], with_pgrads=dispatch["with_pgrads"],
            capture_stride=stride, scalar_stride=scalar_stride,
            activation=dispatch["activation"], return_scalars=True,
            mask_perc=dispatch.get("mask_perc"), output_var=dispatch["output_var"],
            bf16_matmul=bf16, **phase,
        ))
        new_latents, pgrads = outs[0], outs[1]
        k = 2
        traj = traj3 = None
        if stride:
            traj = outs[k]
            k += 1
            if output_pc:
                traj3 = outs[k]
                k += 1
        scalars = outs[k]
        warm_mv = outs[k + 1] if dispatch["mode"] == "warm" else None
        dims, (_, offs, _) = self._latent_layout()
        D_out = gen.model.modules[gen.model.linear_indices[-1]].out_dim
        # the params in force DURING the chain (captures are pre-update)
        chain_last_linear = gen.params[-1]
        gen.latents = new_latents
        if warm_mv is not None:
            def split(packed, tail=None):
                # aligned [B, XW] -> per-latent blocks, and the output-PC
                # site's moments [B, pD] -> [B, D]
                blocks = tuple(packed[:, o : o + d].contiguous()
                               for o, d in zip(offs, dims))
                if tail is not None:
                    blocks += (tail[:, :D_out].contiguous(),)
                return blocks

            # the chain's final moments, as the Adam state the engine's
            # optimizer-x would hold after these steps
            with span("mcpc.trainer.warm_state"):
                count = self.T + (warm_cont[2] if warm_cont is not None else 0)
                self._opt_x_state = adam_state(
                    {"latents": split(warm_mv[0], warm_mv[2] if output_pc else None)},
                    {"latents": split(warm_mv[1], warm_mv[3] if output_pc else None)},
                    count)
        if dispatch["with_pgrads"] and self.opt_p_spec is not None:
            with span("mcpc.trainer.param_update"):
                opt_p = self.opt_p_spec.make()
                if self._opt_p_state is None:
                    self._opt_p_state = opt_p.init(gen.params)
                divisor = float(cfg.plan.p_divisor_steps * inputs.shape[0])
                updates, self._opt_p_state = opt_p.update(
                    tree_scale(pgrads, 1.0 / divisor), self._opt_p_state, gen.params)
                gen.params = apply_updates(gen.params, updates)
            self.kernel_param_updates += 1
        # pre-update scalars per step: the captured steps (or slots), then
        # the final step
        loss_rows, energy_rows = scalars["loss"], scalars["energy"]
        if cfg.capture_every_t and (traj is not None or scalar_stride):
            loss_v, energy_v = loss_rows[:-1], energy_rows[:-1]
        else:
            loss_v, energy_v = loss_rows[-1:], energy_rows[-1:]
        results = {
            "loss": loss_v,
            "energy": energy_v,
            "overall": loss_v + cfg.energy_coefficient * energy_v,
            "x_lr_scale": torch.full_like(loss_v, scale),
            "stop_t": torch.tensor(-1, dtype=torch.int32),
        }
        if traj is not None:
            if dispatch.get("capture_xs"):
                xs = tuple(traj[:, :, o : o + d] for o, d in zip(offs, dims))
                if output_pc:
                    xs += (traj3[:, :, :D_out],)
                results["xs"] = xs
            if dispatch.get("capture_representations"):
                ri = cfg.rep_index
                results["representations"] = traj[:, :, offs[ri] : offs[ri] + dims[ri]]
            if dispatch.get("capture_outputs"):
                if output_pc:
                    # the trailing PC site is the model's output in a
                    # train-mode forward
                    results["outputs"] = traj3[:, :, :D_out]
                else:
                    # outputs_t = act(x2_t) @ W3 + b3, the pre-update forward
                    x2 = traj[:, :, offs[2] : offs[2] + dims[2]]
                    results["outputs"] = (activation_fn(dispatch["activation"])(x2)
                                          @ chain_last_linear["w"] + chain_last_linear["b"])
        return results

    # -- core entry point -------------------------------------------------------

    def _get_fn(self, cfg: EngineConfig):
        fn = self._fns.get(cfg)
        if fn is None:
            fn = build_train_on_batch(self.gen.model, cfg)
            self._fns[cfg] = fn
        return fn

    def train_on_batch(
        self,
        inputs: Tensor,
        loss_fn: tp.Optional[tp.Callable] = None,
        loss_fn_kwargs: tp.Optional[dict] = None,
        is_sample_x_at_batch_start: bool = True,
        is_reset_optimizer_x_at_batch_start: bool = False,
        is_reset_optimizer_p_at_batch_start: bool = False,
        is_optimize_inputs: bool = False,
        callback_after_t: tp.Optional[LangevinStep] = None,
        langevin_var: tp.Optional[float] = None,
        is_return_results_every_t: bool = True,
        is_return_outputs: bool = False,
        is_return_representations: bool = False,
        is_return_xs: bool = False,
        is_return_batchelement_loss: bool = False,
        capture_stride: int = 1,
        key: tp.Optional[torch.Generator] = None,
        chain_seed: tp.Optional[int] = None,
    ) -> dict:
        """Run T inference iterations on one batch.  Returns the results dict
        with per-step ``loss`` / ``energy`` / ``overall`` / ``x_lr_scale``
        tensors, ``stop_t``, plus the requested captures.  ``key`` is a
        ``torch.Generator`` for this call's latent sampling, noise and chain
        seed (default: the model's).  ``chain_seed`` fixes the fused chain's
        noise seed instead of drawing it; the engine, whose noise comes from
        the generator, does not read it."""
        with span("mcpc.train_on_batch"):
            inputs = torch.as_tensor(inputs)
            loss_fn_kwargs = dict(loss_fn_kwargs or {})
            # kwargs that select static slices / reductions are bound into the
            # loss function ('perc' of the masked losses)
            static_keys = tuple(
                k for k in ("perc", "_reduction") if k in loss_fn_kwargs
            )
            if loss_fn is not None and static_keys:
                static_part = tuple((k, loss_fn_kwargs.pop(k)) for k in static_keys)
                loss_fn = _static_loss_partial(loss_fn, static_part)
            if isinstance(callback_after_t, LangevinStep):
                langevin_var = callback_after_t.var
            elif callback_after_t is not None:
                raise TypeError(
                    "callback_after_t must be a LangevinStep; arbitrary callbacks "
                    "are not run between steps — express the hook as config (see "
                    "LangevinStep) or post-process results."
                )

            gen = self.gen
            generator = key if key is not None else gen.generator
            # latent (re)sampling triggers
            resample = is_sample_x_at_batch_start
            if not resample:
                if gen.latents is None:
                    warnings.warn(
                        "latents have not been initialized yet; sampling them now.",
                        RuntimeWarning,
                    )
                    resample = True
                elif gen.latents[0].shape[0] != inputs.shape[0]:
                    warnings.warn(
                        "batch size changed; resampling latents.", RuntimeWarning,
                    )
                    resample = True

            if resample:
                gen.sample_latents(inputs, generator)
                self.recreate_optimizer_x()
            elif is_reset_optimizer_x_at_batch_start:
                self.recreate_optimizer_x()
            if is_reset_optimizer_p_at_batch_start:
                self.recreate_optimizer_p()

            cfg = EngineConfig(
                plan=self.plan,
                optimizer_x=self.opt_x_spec,
                optimizer_p=self.opt_p_spec,
                energy_coefficient=self.energy_coefficient,
                x_lr_discount=self.x_lr_discount,
                x_lr_amplifier=self.x_lr_amplifier,
                langevin_var=langevin_var,
                loss_fn=loss_fn,
                loss_x_fn=self.loss_x_fn,
                loss_inputs_fn=self.loss_inputs_fn,
                early_stop_fn=self.early_stop_fn,
                update_p_at_early_stop=self.update_p_at_early_stop,
                optimize_inputs=is_optimize_inputs,
                capture_every_t=is_return_results_every_t,
                capture_outputs=is_return_outputs,
                capture_representations=is_return_representations,
                capture_xs=is_return_xs,
                capture_overall_elementwise=is_return_batchelement_loss,
                capture_stride=int(capture_stride),
            )
            dispatch = self._kernel_eligible(
                cfg, loss_fn, is_optimize_inputs, langevin_var, inputs.shape[0]
            )
            if dispatch is not None and any(
                k.startswith("energy__") for k in loss_fn_kwargs
            ):
                # extra energy inputs aren't representable in the chain
                dispatch = self._no_kernel(
                    "energy__* extra energy inputs", "a plain energy_fn"
                )
            if dispatch is None:
                self._warn_kernel_fallback(inputs.device)
            else:
                self.kernel_calls += 1
                results = self._run_kernel(
                    dispatch, cfg, inputs, loss_fn_kwargs, langevin_var, generator, chain_seed)
                if not is_return_results_every_t:
                    results = _last_only_results(results)
                return results

            self.engine_calls += 1
            fn = self._get_fn(cfg)
            opt_x = self.opt_x_spec.make()
            xs_tree = {"latents": gen.latents}
            if is_optimize_inputs:
                xs_tree["inputs"] = inputs
            if self._opt_x_state is None:
                self._opt_x_state = opt_x.init(xs_tree)
            if self._opt_p_state is None and self.opt_p_spec is not None:
                self._opt_p_state = self.opt_p_spec.make().init(gen.params)

            state = EngineState(
                params=gen.params,
                latents=gen.latents,
                opt_x_state=self._opt_x_state,
                opt_p_state=self._opt_p_state,
                lr_scale=self._lr_scale,
                generator=generator,
            )
            new_state, results = fn(state, inputs, loss_fn_kwargs)

            gen.params = new_state.params
            gen.latents = tuple(new_state.latents)
            self._opt_x_state = new_state.opt_x_state
            self._opt_p_state = new_state.opt_p_state
            self._lr_scale = new_state.lr_scale
            if cfg.dynamic_x_lr:
                # the live scale now exists only in the engine's state; the host
                # mirror is unknown until set_x_lr / recreate_optimizer_x
                self._lr_scale_host = None

            if not is_return_results_every_t:
                results = _last_only_results(results)
            return results
