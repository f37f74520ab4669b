"""Helpers for the port's parity tests: hand the JAX package's random draws
to the port, run the JAX trainers on their fused chain off TPU, and switch
the Langevin noise off in both packages.

Torch cannot reproduce ``jax.random`` streams.  ``share_streams`` records
the latents the JAX package samples at a batch's start and the noise seeds
of its fused-chain calls, as its calls run, and hands the same values to the
port's calls in the same order: run the JAX side first.
"""

import jax
import numpy as np
import torch

import montecarlopredictivecoding_tpu as mcpc
import montecarlopredictivecoding_tpu_torch as mt
from montecarlopredictivecoding_tpu.core import trainer as jtrainer


def share_streams(monkeypatch):
    """Record the JAX package's sampled latents and chain seeds and replay
    them in the port; returns the two queues (empty once all are used)."""
    latents, seeds = [], []
    j_sample = mcpc.GenerativeModel.sample_latents
    j_run = jtrainer.PCTrainer._run_pallas

    def record_latents(self, inputs, key=None):
        out = j_sample(self, inputs, key)
        latents.append([np.asarray(x) for x in out])
        return out

    def record_seed(self, dispatch, cfg, inputs, loss_fn_kwargs, langevin_var, key):
        seeds.append(int(jax.random.randint(key, (), 0, 2**31 - 1)))
        return j_run(self, dispatch, cfg, inputs, loss_fn_kwargs, langevin_var, key)

    def replay_latents(self, inputs, generator=None):
        self.latents = tuple(torch.from_numpy(np.array(x)).to(inputs.device)
                             for x in latents.pop(0))
        return self.latents

    monkeypatch.setattr(mcpc.GenerativeModel, "sample_latents", record_latents)
    monkeypatch.setattr(jtrainer.PCTrainer, "_run_pallas", record_seed)
    monkeypatch.setattr(mt.GenerativeModel, "sample_latents", replay_latents)
    monkeypatch.setattr(mt.PCTrainer, "_chain_seed", lambda self, generator: seeds.pop(0))
    return latents, seeds


def on_the_kernel(factory):
    """A JAX trainer factory whose trainers take the fused chain off TPU
    (Pallas in interpret mode)."""
    def make(*args, **kwargs):
        tr = factory(*args, **kwargs)
        tr.use_pallas = True
        return tr

    return make


def langevin_off(monkeypatch, *port_modules):
    """Every ``LangevinStep`` the JAX package's figures make (through the
    package's ``mcpc.LangevinStep``) and each given port module makes has
    variance 0: the chains run without noise."""
    monkeypatch.setattr(mcpc, "LangevinStep", lambda var=2.0: jtrainer.LangevinStep(var=0.0))
    for module in port_modules:
        monkeypatch.setattr(module, "LangevinStep", lambda var=2.0: mt.LangevinStep(var=0.0))


def record_results(monkeypatch):
    """The results of every JAX ``PCTrainer.train_on_batch`` call, in call
    order, as numpy trees."""
    calls = []
    orig = jtrainer.PCTrainer.train_on_batch

    def spy(self, *args, **kwargs):
        out = orig(self, *args, **kwargs)
        calls.append(jax.tree_util.tree_map(np.asarray, out))
        return out

    monkeypatch.setattr(jtrainer.PCTrainer, "train_on_batch", spy)
    return calls
