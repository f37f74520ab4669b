"""What every driver shares: seeds, weights and images made from the run's
seed on the device, the port's model and configuration dicts, and the
gap statistics the comparison reports."""

from __future__ import annotations

import dataclasses
import math
import statistics
import time
import typing as tp

import torch

from port_bench.reference import mcpc as ref

MASK64 = (1 << 63) - 1


def derive(seed: int, *keys: int) -> int:
    """A 63-bit seed for the stream ``keys`` of the run ``seed``."""
    h = int(seed) & MASK64
    for k in keys:
        h = (h * 6364136223846793005 + 1442695040888963407 + int(k)) & MASK64
    return h


def device_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def make_params(dims, seed: int, device) -> tp.List[dict]:
    """The four layers' float32 weights, uniform in +-1/sqrt(in) as the
    model's own initialisation, drawn on the device in one call."""
    u = torch.rand(ref.n_params(dims), generator=device_generator(derive(seed, 1), device),
                   device=device)
    return ref.init_params(dims, u)


def make_images(n: int, D: int, seed: int, device, strokes: int = 3, width: float = 1.0,
                chunk: int = 4096) -> torch.Tensor:
    """``n`` distinct images of ``D`` pixels in [0, 1] (a square of side
    sqrt(D)): the brightest of ``strokes`` line strokes with a Gaussian
    profile of ``width`` pixels between random end points, as pen strokes
    of a handwritten digit.  Drawn on the device from ``seed``."""
    side = math.isqrt(D)
    if side * side != D:
        raise ValueError(f"{D} pixels are not a square image")
    g = device_generator(derive(seed, 2), device)
    ends = side * (0.15 + 0.7 * torch.rand((n, strokes, 2, 2), generator=g, device=device))
    yy, xx = torch.meshgrid(torch.arange(side, dtype=torch.float32, device=device),
                            torch.arange(side, dtype=torch.float32, device=device), indexing="ij")
    pix = torch.stack([xx.reshape(-1), yy.reshape(-1)], -1)  # [D, 2]
    out = torch.empty((n, D), device=device)
    for lo in range(0, n, chunk):
        a, b = ends[lo : lo + chunk, :, 0], ends[lo : lo + chunk, :, 1]  # [c, s, 2]
        d = (b - a)[:, :, None]
        rel = pix[None, None] - a[:, :, None]
        t = ((rel * d).sum(-1) / (d * d).sum(-1).clamp(min=1e-6)).clamp(0.0, 1.0)
        dist2 = ((rel - t[..., None] * d) ** 2).sum(-1)
        out[lo : lo + chunk] = torch.exp(dist2 / (-2.0 * width * width)).amax(1)
    return out


def port_model(dims):
    """The port's generative MLP of these widths (relu, uniform latent
    initialisation)."""
    from montecarlopredictivecoding_tpu_torch.core.model import make_mlp_model

    return make_mlp_model(*dims, activation="relu")


def port_config(dims, **entries) -> dict:
    """A configuration dict as the port's entry points read it."""
    from montecarlopredictivecoding_tpu_torch.core.losses import bernoulli_fn

    d0, d1, d2, D = dims
    return {"input_size": d0, "hidden_size": d1, "hidden2_size": d2, "output_size": D,
            "loss_fn": bernoulli_fn, "activation_fn": "relu", "input_var": None, **entries}


def replay_latents(gen: torch.Generator, B: int, dims) -> torch.Tensor:
    """The latents [B, d0+d1+d2] that the model's uniform initialisation
    draws from ``gen`` (its three sites in order, -10 + 20 u in float32)."""
    return torch.cat([-10.0 + 20.0 * torch.rand((B, d), generator=gen) for d in dims[:3]], 1)


def replay_chain_seed(gen: torch.Generator) -> int:
    """A chain seed as the program draws one from ``gen``."""
    return int(torch.randint(0, 2 ** 31 - 1, (), generator=gen))


def row_gaps(a: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Each row's largest |a - r| over the row's largest |r| (float64;
    leading axes kept)."""
    a, r = a.double(), r.double()
    scale = r.abs().amax(-1).clamp(min=1e-30)
    return (a - r).abs().amax(-1) / scale


def p95(values: tp.Sequence[float]) -> float:
    """The 95th percentile (``statistics.quantiles``' exclusive method)."""
    return statistics.quantiles(values, n=20)[18] if len(values) > 1 else values[0]


# the quantile of the row gaps a stage reports, interpolated: the median,
# above every share of rows that Adam's chaotic steps part under correct
# roundings (up to 29% measured), and where half the batch is spoilt it
# reads half a spoilt row's gap
ROW_SHARE = 0.5


def row_share_gap(gaps: torch.Tensor) -> torch.Tensor:
    """The ``ROW_SHARE`` quantile of the row gaps along the last axis."""
    return torch.quantile(gaps, ROW_SHARE, dim=-1)


@dataclasses.dataclass
class Number:
    """A compared number and its limit; ``ok`` when it is within."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def leaf_norms(tree) -> tp.List[float]:
    return [float(torch.linalg.vector_norm(t.double())) for p in tree for t in (p["w"], p["b"])]


def worst_leaf_gap(prog: tp.Sequence[float], refs: tp.Sequence[float],
                   keep: tp.Sequence[bool]) -> float:
    """The largest |prog - ref| of the kept leaves' norms, each over the
    larger of its reference norm and the median kept leaf's."""
    kept = [r for r, k in zip(refs, keep) if k]
    med = sorted(kept)[len(kept) // 2]
    return max(abs(p - r) / max(r, med) for p, r, k in zip(prog, refs, keep) if k)


class Marks:
    """The window's clock: a mark at its start and after each item (CUDA
    events on the card, the host clock elsewhere), and its length on the host
    clock from the first mark to the last item's completion."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks: tp.List[tp.Any] = []
        self.sync()
        self.mark()
        self.t0 = time.perf_counter()

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def mark(self) -> None:
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
        else:
            e = time.perf_counter()
        self.marks.append(e)

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def close(self) -> float:
        """Waits for the device; the window's seconds."""
        self.sync()
        return self.elapsed()

    def item_ms(self) -> tp.List[float]:
        """Each item's time, from the mark before it to its own."""
        pairs = zip(self.marks, self.marks[1:])
        if self.cuda:
            return [a.elapsed_time(b) for a, b in pairs]
        return [1e3 * (b - a) for a, b in pairs]
