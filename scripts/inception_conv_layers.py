"""InceptionV3's 94 BasicConv2d layers one by one on the card: the
hand-written kernel (``ops/inception_conv.py``) against float64, beside the
FMA route (cuDNN, TF32 off) and a planted single-pass TF32 variant, and the
kernel's time a forward beside its bound, its plain version's and the
library's (cuDNN's convolution, PyTorch's BatchNorm and relu).

    python3 scripts/inception_conv_layers.py [--batch 64] [--seed 7] [--no-gaps]

Every layer takes the input it gets in a forward of ``--batch`` images
(the benchmark's seeded torchvision-layout weights,
``port_bench/reference/inception.random_state_dict``).  A layer's gap is
its worst image's largest element gap over that image's largest float64
output.  The planted variant is the same kernel on operands rounded to
TF32 first (no low parts): single-pass TF32 products with f32 sums.
Writes ``chiprun_out/inception_conv_layers_b<batch>.json``.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
import typing as tp

import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

from montecarlopredictivecoding_tpu_torch.eval import inception as inc  # noqa: E402
from montecarlopredictivecoding_tpu_torch.ops import inception_conv as ic  # noqa: E402
from montecarlopredictivecoding_tpu_torch.utils.precision import full_f32_conv  # noqa: E402
from port_bench.reference import inception as ref  # noqa: E402

PEAK_FLOPS = 165e12   # three TF32 products at 495 TFLOP/s: the f32-accurate peak


class Layer(tp.NamedTuple):
    name: str
    x: torch.Tensor          # the input as the kernel takes it (channels-last)
    p: dict
    stride: int
    padding: tp.Tuple[int, int]

    @property
    def layer(self) -> ic.ConvLayer:
        return inc.layer_of(self.p)

    def flops(self) -> int:
        n, _, h, w = self.x.shape
        kh, kw = self.layer.kernel_size
        P, Q = ic.output_size(h, w, (kh, kw), self.stride, self.padding)
        return 2 * n * P * Q * self.layer.c_out * self.layer.c_in * kh * kw


def weights(seed: int, device) -> dict:
    return inc.load_torch_state_dict(ref.random_state_dict(seed), device=device)


def images(batch: int, seed: int, device) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.rand((batch, 1, 28, 28), generator=g).to(device).expand(-1, 3, -1, -1)


def layer_inputs(params: dict, x: torch.Tensor) -> tp.List[Layer]:
    """Every BasicConv2d of one forward of ``x``, with the input it got."""
    names = {}
    for path, *_ in inc.conv_spec():
        leaf = params
        for k in path.split("."):
            leaf = leaf[k]
        names[id(leaf)] = path
    found: tp.List[Layer] = []
    original = inc.basic_conv

    def record(x, p, stride=1, padding=(0, 0), out=None):
        found.append(Layer(names[id(p)], x, p, stride,
                           padding if isinstance(padding, tuple) else (padding, padding)))
        return original(x, p, stride, padding, out)

    inc.basic_conv = record
    try:
        with torch.no_grad():
            inc.inception_pool3_features(params, x)
    finally:
        inc.basic_conv = original
    return found


def float64_output(L: Layer) -> torch.Tensor:
    """conv -> BatchNorm -> relu in float64 from the loaded parameters."""
    p = L.p
    x = L.x.double().contiguous()
    w = F.pad(p["w"].double(), (0, 0, 0, 0, 0, x.shape[1] - p["w"].shape[1]))
    inv = torch.rsqrt(p["bn_v"].double() + 1e-3)
    scale = p["bn_w"].double() * inv
    shift = p["bn_b"].double() - p["bn_m"].double() * scale
    y = F.conv2d(x, w, None, L.stride, L.padding)
    return torch.relu(y * scale[None, :, None, None] + shift[None, :, None, None])


def worst_row_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    n = want.shape[0]
    diff = (got.double() - want).abs().reshape(n, -1).amax(1)
    return float((diff / want.abs().reshape(n, -1).amax(1).clamp_min(1e-300)).max())


def single_pass(layer: ic.ConvLayer) -> ic.ConvLayer:
    """The layer with its weights rounded to TF32: no low parts."""
    return ic.ConvLayer(w=layer.w, scale=layer.scale, shift=layer.shift,
                        packed=ic.pack_weights(ic.tf32_round(layer.w.float().contiguous())))


def gaps(L: Layer) -> dict:
    """The kernel's, the FMA route's and the planted variant's gaps from
    float64 on one layer's input."""
    want = float64_output(L)
    kernel = ic.conv_bn_relu(L.x, L.layer, L.stride, L.padding)
    fma = ic.conv_bn_relu_reference(L.x.contiguous(), L.layer, L.stride, L.padding)
    planted = ic.conv_bn_relu(ic.tf32_round(L.x), single_pass(L.layer), L.stride, L.padding)
    return {"kernel": worst_row_gap(kernel, want), "fma": worst_row_gap(fma, want),
            "single_pass": worst_row_gap(planted, want)}


def timed_ms(fn, reps: int = 5) -> float:
    """Median ms of ``fn()`` over ``reps`` runs after one warm-up, CUDA
    events around each run."""
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def library_conv(L: Layer, x: torch.Tensor) -> torch.Tensor:
    """cuDNN's f32 convolution (TF32 off), PyTorch's eval BatchNorm, relu."""
    p = L.p
    w = F.pad(p["w"], (0, 0, 0, 0, 0, x.shape[1] - p["w"].shape[1]))
    with full_f32_conv():
        y = F.conv2d(x, w, None, L.stride, L.padding)
    y = F.batch_norm(y, p["bn_m"], p["bn_v"], p["bn_w"], p["bn_b"], False, 0.0, 1e-3)
    return torch.relu_(y)


def times(layers: tp.List[Layer]) -> dict:
    """ms a forward of the 94 layers: the kernel (each layer's own too),
    its plain version and the library's, on the same inputs."""
    nchw = [L.x.contiguous() for L in layers]
    per_layer = [timed_ms(lambda L=L: ic.conv_bn_relu(L.x, L.layer, L.stride, L.padding))
                 for L in layers]
    return {
        "kernel_ms": timed_ms(lambda: [ic.conv_bn_relu(L.x, L.layer, L.stride, L.padding)
                                       for L in layers]),
        "plain_ms": timed_ms(lambda: [ic.conv_bn_relu_reference(x, L.layer, L.stride, L.padding)
                                      for L, x in zip(layers, nchw)], reps=3),
        "library_ms": timed_ms(lambda: [library_conv(L, x) for L, x in zip(layers, nchw)],
                               reps=3),
        "per_layer_ms": per_layer,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--no-gaps", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("inception_conv_layers: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    params = weights(args.seed, dev)
    layers = layer_inputs(params, images(args.batch, args.seed + 1, dev))
    torch.cuda.synchronize()
    print(f"{card}: {len(layers)} layers at B={args.batch}, inputs in "
          f"{time.perf_counter() - t0:.1f} s (library built and loaded)")
    rows = []
    if not args.no_gaps:
        for L in layers:
            with torch.no_grad():
                rows.append(dict(name=L.name, **gaps(L)))
        torch.cuda.synchronize()
        print(f"gaps in {time.perf_counter() - t0:.1f} s")
    t = times(layers)
    flops = [L.flops() for L in layers]
    bound_ms = 1e3 * sum(flops) / PEAK_FLOPS
    for i, L in enumerate(layers):
        ms = t["per_layer_ms"][i]
        n, c, h, w = L.x.shape
        P, Q = ic.output_size(h, w, L.layer.kernel_size, L.stride, L.padding)
        line = (f"{L.name:28s} M={n * P * Q:8d} N={L.layer.c_out:4d} "
                f"K={c * L.layer.kernel_size[0] * L.layer.kernel_size[1]:5d} "
                f"tile={ic.tile_for(n * P * Q, L.layer.c_out)} {ms:8.4f} ms "
                f"{flops[i] / ms / 1e9:7.2f} TFLOP/s")
        if rows:
            r = rows[i]
            line += (f"  gap {r['kernel']:.3e} fma {r['fma']:.3e} "
                     f"single-pass {r['single_pass']:.3e}")
        print(line)
    print(f"forward of {len(layers)} layers at B={args.batch}: kernel {t['kernel_ms']:.3f} ms "
          f"(sum of layers {sum(t['per_layer_ms']):.3f}), bound {bound_ms:.3f} ms "
          f"({100 * bound_ms / t['kernel_ms']:.1f}%), "
          f"{sum(flops) / t['kernel_ms'] / 1e9:.2f} TFLOP/s; plain {t['plain_ms']:.3f} ms, "
          f"library {t['library_ms']:.3f} ms [{card}]")
    if rows:
        print("worst layer gaps: kernel {:.3e}, fma {:.3e}, single-pass {:.3e}; least "
              "single-pass/kernel ratio {:.1f}".format(
                  max(r["kernel"] for r in rows), max(r["fma"] for r in rows),
                  max(r["single_pass"] for r in rows),
                  min(r["single_pass"] / max(r["kernel"], 1e-300) for r in rows)))
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", f"inception_conv_layers_b{args.batch}.json"),
              "w") as f:
        json.dump({"card": card, "batch": args.batch, "bound_ms": bound_ms, "gaps": rows,
                   "names": [L.name for L in layers], **t}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
