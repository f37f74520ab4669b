"""InceptionV3's conv -> BatchNorm -> relu kernel (``ops/inception_conv.py``)
on the card, against float64.

This file imports neither JAX nor the JAX package (``tests/conftest.py``
imports JAX, hence ``--noconftest``):

    python -m pytest tests/test_torch_inception_conv_cuda.py -q -m cuda --noconftest -s

Without a CUDA device every test here skips.  Each of the 94 layers takes
the input it gets in a forward of the benchmark's seeded weights
(``scripts/inception_conv_layers.py``), at the extractor's batch of 64 and
the call's last batch of 8.  A layer's gap is its worst image's largest
element gap over that image's largest float64 output.  Tolerances: the
kernel at most 2e-6 a layer (the card read at most 8.8e-7, the FMA route
up to 2.9e-6), and a planted single-pass TF32 variant (operands rounded to
TF32, no low parts) at least 30 times the kernel's gap on every layer (it
read 466 times or more), so that the comparison tells the precisions apart.
"""

import pathlib
import sys

import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "scripts"))

import inception_conv_layers as layers_mod  # noqa: E402
from montecarlopredictivecoding_tpu_torch.eval import inception as inc  # noqa: E402
from montecarlopredictivecoding_tpu_torch.ops import inception_conv as ic  # noqa: E402

SEED = 7
GAP = 2e-6
PLANTED = 30


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def params(card):
    return layers_mod.weights(SEED, card)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [64, 8])
def test_every_layer_against_float64(card, params, batch):
    layers = layers_mod.layer_inputs(params, layers_mod.images(batch, SEED + 1, card))
    assert len(layers) == 94
    with torch.no_grad():
        rows = [layers_mod.gaps(L) for L in layers]
    for L, r in zip(layers, rows):
        print(f"B={batch} {L.name}: kernel {r['kernel']:.3e}, FMA route {r['fma']:.3e}, "
              f"single-pass TF32 {r['single_pass']:.3e}")
    bad = [(L.name, r) for L, r in zip(layers, rows)
           if not (r["kernel"] <= GAP and r["single_pass"] >= PLANTED * r["kernel"])]
    assert bad == []


@pytest.mark.cuda
def test_a_forward_launches_the_kernel_94_times(card, params):
    x = layers_mod.images(8, SEED + 2, card)
    before = ic.conv_bn_relu.launches
    with torch.no_grad():
        features = inc.inception_pool3_features(params, x)
    torch.cuda.synchronize()
    assert ic.conv_bn_relu.launches == before + 94
    assert features.shape == (8, 2048) and bool(torch.isfinite(features).all())


@pytest.mark.cuda
def test_a_channel_slice_takes_the_same_bits(card, params):
    """The kernel's store into channels [c0, c0 + C_out) of a wider
    channels-last output equals its own fresh output bit for bit and leaves
    the other channels as they were."""
    p = params["Mixed_6b"]["branch1x1"]
    g = torch.Generator(device=card).manual_seed(3)
    x = torch.rand((4, 768, 17, 17), generator=g, device=card).contiguous(
        memory_format=torch.channels_last)
    fresh = ic.conv_bn_relu(x, p["layer"])
    out = torch.full((4, 768, 17, 17), -1.0, device=card).contiguous(
        memory_format=torch.channels_last)
    ic.conv_bn_relu(x, p["layer"], out=out[:, 384:576])
    torch.cuda.synchronize()
    assert torch.equal(out[:, 384:576], fresh)
    assert bool((out[:, :384] == -1).all()) and bool((out[:, 576:] == -1).all())


@pytest.mark.cuda
def test_the_wrapper_refuses_what_the_kernel_does_not_take(card, params):
    layer = params["Mixed_5b"]["branch1x1"]["layer"]
    x = torch.rand((2, 192, 9, 9), device=card)
    with pytest.raises(ValueError, match="channels-last"):
        ic.conv_bn_relu(x, layer)
    with pytest.raises(TypeError, match="float32"):
        ic.conv_bn_relu(x.double().contiguous(memory_format=torch.channels_last), layer)
    x = x.contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="channels"):
        ic.conv_bn_relu(x[:, :96], layer)
    out = torch.empty((2, 70, 9, 9), device=card).contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="even"):
        ic.conv_bn_relu(x, layer, out=out[:, 1:65])
