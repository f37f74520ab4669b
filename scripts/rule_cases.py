"""Other correct f32 orders and injected faults of the plain chain version,
shared by ``tests/test_torch_chain_holds.py`` (on the CPU) and
``scripts/rule_calibration.py`` (on a GPU), which hold them by
``chip_smoke.py``'s row rule in the kernel's place.

Correct orders that are not among the rule's witnesses: every f32 product
summed in two halves of k added, or taken in float64 and rounded once
(``other_order``), the latents started one ulp away (``one_ulp_off``), and
the split-TF32 products of ``tf32_split_matmul`` (``split_products``).
Faults: ``patched`` replaces a function of ``ops/mcpc_chain.py`` while the
plain version runs, for example with ``stale_row`` (one row's update
skipped for one step; ``stale_run`` where the step rule splits the chain)
or ``no_bias_correction`` (Adam's bias correction off).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch


@contextlib.contextmanager
def other_order(how: str):
    """Every f32 product summed in two halves of k added (``"halves"``) or
    taken in float64 and rounded once (``"float64"``)."""
    plain = torch.Tensor.__matmul__

    def matmul(a, b):
        if a.dtype != torch.float32 or b.dtype != torch.float32:
            return plain(a, b)
        if how == "halves":
            h = a.shape[-1] // 2
            return plain(a[..., :h], b[..., :h, :]) + plain(a[..., h:], b[..., h:, :])
        return plain(a.double(), b.double()).float()

    torch.Tensor.__matmul__ = matmul
    try:
        yield
    finally:
        torch.Tensor.__matmul__ = plain


@contextlib.contextmanager
def split_products(chain):
    """Every float32 ``a @ b`` as ``chain.tf32_split_matmul`` takes it."""
    plain = torch.Tensor.__matmul__

    def split(a, b):
        if a.dtype == torch.float32 and b.dtype == torch.float32:
            return chain.tf32_split_matmul(a, b)
        return plain(a, b)

    torch.Tensor.__matmul__ = split
    try:
        yield
    finally:
        torch.Tensor.__matmul__ = plain


def one_ulp_off(latents, seed: int):
    """Each latent moved one ulp up or down, the direction drawn from
    ``seed``."""
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.nextafter(x, torch.where(
        torch.rand(x.shape, generator=g).to(x.device) < 0.5,
        torch.tensor(float("inf"), device=x.device),
        torch.tensor(float("-inf"), device=x.device)))
        for x in latents)


@contextlib.contextmanager
def patched(chain, name: str, fn):
    """``chain.<name>`` replaced by ``fn(the original)`` meanwhile."""
    saved = getattr(chain, name)
    setattr(chain, name, fn(saved))
    try:
        yield
    finally:
        setattr(chain, name, saved)


def stale_row(rows: int, row: int, step: int):
    """A replacement for ``activation_fn``, which the chain calls on its
    latents once a step: at ``step`` it keeps ``row``'s pre-update latents,
    one step later it writes them back (that row's update of one step
    skipped, as a stale read past a barrier would).  ``rows``: the batch."""
    def wrap(saved):
        calls, kept = [0], {}

        def activation(name):
            act = saved(name)

            def stale(X):
                if X.dim() == 2 and X.shape[0] == rows:
                    if calls[0] == step:
                        kept["row"] = X[row].clone()
                    elif calls[0] == step + 1:
                        X[row] = kept["row"]
                    calls[0] += 1
                return act(X)
            return stale
        return activation
    return wrap


def stale_run(run, chain, rows: int, row: int, step: int, warm_T: int):
    """``run`` with ``stale_row`` patched in, ``step`` counted over the
    whole chain of ``warm_T`` warm steps: a Langevin-only call (``warm_T``
    0, as the step rule splits a chain with both phases) counts from the
    warm phase's end."""
    def wrapped(*args, **kw):
        at = step - (warm_T if warm_T and not kw.get("warm_T") else 0)
        with patched(chain, "activation_fn", stale_row(rows, row, at)):
            return run(*args, **kw)
    return wrapped


def no_bias_correction(saved):
    """A replacement for ``_chain_args``: Adam's bias correction off."""
    return lambda *a, **kw: dataclasses.replace(saved(*a, **kw), bias0=(0.0, 0.0))
