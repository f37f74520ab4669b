"""InceptionV3's BasicConv2d kernel (``ops/inception_conv.py``) on the CPU:
what it takes from the weights at load (the TF32 split, the packed layout,
the BatchNorm's vectors), its tile choice, its plain version, and the graph
(``eval/inception.py``) that stores each branch into a channel slice of its
block's output, held bit for bit to the graph as it was (each block a
``torch.cat`` of its branches).  The kernel itself runs on the card only
(``tests/test_torch_inception_conv_cuda.py``).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from montecarlopredictivecoding_tpu_torch.eval import inception as inc
from montecarlopredictivecoding_tpu_torch.ops import inception_conv as ic

torch.set_num_threads(1)


def random_state_dict(seed=0, spec=None):
    """torchvision-layout weights of variance 1/fan_in, batch norms off the
    identity."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for path, c_in, c_out, k in spec or inc.conv_spec():
        sd[f"{path}.conv.weight"] = torch.randn((c_out, c_in) + k, generator=g) / np.sqrt(
            c_in * k[0] * k[1])
        sd[f"{path}.bn.weight"] = 0.8 + 0.4 * torch.rand(c_out, generator=g)
        sd[f"{path}.bn.bias"] = 0.1 * torch.randn(c_out, generator=g)
        sd[f"{path}.bn.running_mean"] = 0.1 * torch.randn(c_out, generator=g)
        sd[f"{path}.bn.running_var"] = 0.5 + torch.rand(c_out, generator=g)
    return sd


def leaves(sd, spec):
    """``{path: leaf}`` of ``spec``'s layers, each with its prepared layer."""
    out = {}
    for path, *_ in spec:
        leaf = {"w": sd[f"{path}.conv.weight"], "bn_w": sd[f"{path}.bn.weight"],
                "bn_b": sd[f"{path}.bn.bias"], "bn_m": sd[f"{path}.bn.running_mean"],
                "bn_v": sd[f"{path}.bn.running_var"]}
        leaf["layer"] = inc.layer_of(leaf)
        out[path] = leaf
    return out


def bits(t):
    return t.contiguous().view(torch.int32)


def test_the_split_keeps_tf32_halves_that_sum_to_the_weight():
    """hi has its low 13 mantissa bits zero (so has lo), and hi + lo is w to
    within 2^-21 relative, over weights of many magnitudes and signs."""
    g = torch.Generator().manual_seed(1)
    w = torch.randn(4096, generator=g) * torch.exp2(torch.randint(-30, 30, (4096,), generator=g))
    hi, lo = ic.split_tf32(w)
    assert int((bits(hi) & 0x1FFF).abs().max()) == 0
    assert int((bits(lo) & 0x1FFF).abs().max()) == 0
    rel = ((hi.double() + lo.double() - w.double()).abs() / w.double().abs()).max()
    assert float(rel) <= 2.0 ** -21
    # the rounding is to nearest with ties away from zero
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12], dtype=torch.float32)
    np.testing.assert_array_equal(ic.tf32_round(tie).numpy(),
                                  np.array([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0],
                                           np.float32))


@pytest.mark.parametrize("c_in,c_out,k", [(3, 32, (3, 3)), (48, 64, (5, 5)), (160, 192, (1, 7)),
                                          (64, 80, (1, 1)), (1280, 448, (1, 1))])
def test_packed_weights_are_the_kernels_stages(c_in, c_out, k):
    """``[C_out / bn, k_tiles * bn * 64]``: K over (kh, kw, C_in padded to
    4) in tiles of 32 (zeros past K), C_out in blocks of bn (zero rows past
    it), and a block's tile ``[hi, lo][8 chunks of 4 K][bn rows][4]``."""
    g = torch.Generator().manual_seed(2)
    w = torch.randn((c_out, c_in) + k, generator=g)
    packed = ic.pack_weights(w)
    bn = ic.n_tile(c_out)
    cp = ic.padded_channels(c_in)
    K = k[0] * k[1] * cp
    k_tiles = -(-K // 32)
    blocks = -(-c_out // bn)
    assert packed.shape == (blocks, k_tiles * bn * 64)
    flat = torch.zeros(blocks * bn, k_tiles * 32)
    flat[:c_out, :K] = F.pad(w.permute(0, 2, 3, 1), (0, cp - c_in)).reshape(c_out, K)
    hi, lo = ic.split_tf32(flat)
    got = packed.view(blocks, k_tiles, 2, 8, bn, 4)
    for part, want in ((0, hi), (1, lo)):
        # row n, K index 32 * kt + 4 * chunk + e
        rebuilt = got[:, :, part].permute(0, 3, 1, 2, 4).reshape(blocks * bn, k_tiles * 32)
        np.testing.assert_array_equal(rebuilt.numpy(), want.numpy())


def test_the_layer_vectors_are_the_batch_norms_bit_for_bit():
    """The scale and shift prepared at load are, bit for bit, the vectors the
    graph's per-batch BatchNorm formula gives (``rsqrt(v + eps)``, ``w *
    inv``, ``b - m * w * inv``), and the graph's ``batch_norm`` applies
    them as it always did."""
    params = inc.load_torch_state_dict(random_state_dict(3), device="cpu")
    x = torch.randn(2, 192, 5, 5, generator=torch.Generator().manual_seed(4))
    for path, *_ in inc.conv_spec():
        p = params
        for k in path.split("."):
            p = p[k]
        inv = torch.rsqrt(p["bn_v"] + 1e-3)
        scale = (p["bn_w"] * inv)[None, :, None, None]
        shift = (p["bn_b"] - p["bn_m"] * p["bn_w"] * inv)[None, :, None, None]
        layer = p["layer"]
        assert torch.equal(bits(layer.scale), bits(scale.flatten()))
        assert torch.equal(bits(layer.shift), bits(shift.flatten()))
        assert layer.packed.shape[0] == -(-p["w"].shape[0] // ic.n_tile(p["w"].shape[0]))
        assert layer.w is p["w"]
        if p["w"].shape[0] == 192:
            assert torch.equal(bits(inc.batch_norm(x, p)), bits(x * scale + shift))


@pytest.mark.parametrize("m,c_out,want", [
    (1_420_864, 32, (128, 32)), (1_382_976, 64, (128, 64)), (322_624, 192, (128, 96)),
    (78_400, 48, (128, 64)), (78_400, 96, (128, 96)), (18_496, 160, (64, 96)),
    (18_496, 192, (64, 96)), (18_496, 384, (64, 128)), (4096, 320, (128, 128)),
    (4096, 448, (128, 128)), (4096, 192, (128, 96)), (512, 384, (128, 128)),
    (341_056, 80, (128, 96)),
])
def test_the_tile_follows_the_shape(m, c_out, want):
    """C_out in the column tile that wastes least (each tile's own work
    counted); M in 128 rows unless that makes between one and four waves of
    blocks."""
    assert ic.tile_for(m, c_out) == want


def test_every_layer_gets_a_kernel_tile_at_both_batches():
    """The 94 layers at B = 64 and the call's last batch of 8: each tile is
    one the library has, its column tile is the packed weights', the
    17 x 17 stage takes the 64-row tile and the 8 x 8 stage the 128-row
    one."""
    params = inc.load_torch_state_dict(random_state_dict(5), device="cpu")
    x = torch.rand(1, 3, 28, 28, generator=torch.Generator().manual_seed(6))
    shapes = []
    original = inc.basic_conv

    def record(x, p, stride=1, padding=(0, 0), out=None):
        shapes.append((x.shape[2:], p["layer"], stride,
                       padding if isinstance(padding, tuple) else (padding, padding)))
        return original(x, p, stride, padding, out)

    inc.basic_conv = record
    try:
        inc.inception_pool3_features(params, x)
    finally:
        inc.basic_conv = original
    assert len(shapes) == 94
    for B in (64, 8):
        for (h, w), layer, stride, padding in shapes:
            P, Q = ic.output_size(h, w, layer.kernel_size, stride, padding)
            bm, bn = ic.tile_for(B * P * Q, layer.c_out)
            assert bm in (64, 128) and bn in (32, 64, 96, 128)
            assert layer.packed.shape[0] == -(-layer.c_out // bn)
            if B == 64 and P in (17, 8):
                assert bm == (64 if P == 17 else 128)


def test_kernel_layout_pads_channels_to_four_channels_last():
    x = torch.rand(2, 3, 5, 7, generator=torch.Generator().manual_seed(7))
    y = ic.kernel_layout(x)
    assert y.shape == (2, 4, 5, 7) and y.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(y[:, :3], x) and not y[:, 3].any()
    z = ic.kernel_layout(torch.rand(2, 8, 3, 3))
    assert z.shape == (2, 8, 3, 3) and z.is_contiguous(memory_format=torch.channels_last)


def test_channel_stride_reads_a_slice_of_a_channels_last_output():
    out = torch.empty((2, 10, 3, 4), memory_format=torch.channels_last)
    assert ic._channel_stride(out) == 10
    assert ic._channel_stride(out[:, 4:8]) == 10 and out[:, 4:8].storage_offset() == 4
    assert ic._channel_stride(torch.empty(2, 10, 3, 4)) is None


@pytest.mark.parametrize("stride,padding,k", [(2, (0, 0), (3, 3)), (1, (1, 1), (3, 3)),
                                              (1, (0, 3), (1, 7)), (1, (3, 0), (7, 1)),
                                              (1, (2, 2), (5, 5)), (1, (0, 0), (1, 1))])
def test_plain_version_is_the_graphs_basic_conv_bit_for_bit(stride, padding, k):
    """The wrapper's plain path (CPU tensors) gives the graph's conv ->
    batch_norm -> relu bit for bit, alone and into a channel slice; a
    channel-padded input (zero channels, zero weights) gives the same
    values to rounding."""
    spec = [("m", 6, 8, k)]
    p = leaves(random_state_dict(8, spec), spec)["m"]
    x = torch.rand(2, 6, 11, 9, generator=torch.Generator().manual_seed(9))
    want = torch.relu(inc.batch_norm(inc.conv2d(x, p["w"], stride, padding), p))
    got = ic.conv_bn_relu(x, p["layer"], stride, padding)
    assert torch.equal(bits(got), bits(want))
    out = torch.zeros((2, 12) + tuple(want.shape[2:]))
    ic.conv_bn_relu(x, p["layer"], stride, padding, out=out[:, 3:11])
    assert torch.equal(bits(out[:, 3:11]), bits(want)) and not out[:, :3].any()
    padded = ic.conv_bn_relu(ic.kernel_layout(x),
                             p["layer"], stride, padding)
    torch.testing.assert_close(padded, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="out is"):
        ic.conv_bn_relu(x, p["layer"], stride, padding, out=out[:, :3])


def _cat_blocks():
    """Each block as the graph computed it before the kernel: its branches
    through ``basic_conv`` one by one, then ``torch.cat``."""
    bc, ap, mp = inc.basic_conv, inc.avg_pool_excl, inc.max_pool

    def a(x, p):
        b1 = bc(x, p["branch1x1"])
        b5 = bc(bc(x, p["branch5x5_1"]), p["branch5x5_2"], padding=(2, 2))
        b3 = bc(x, p["branch3x3dbl_1"])
        b3 = bc(bc(b3, p["branch3x3dbl_2"], padding=(1, 1)), p["branch3x3dbl_3"], padding=(1, 1))
        return torch.cat([b1, b5, b3, bc(ap(x), p["branch_pool"])], dim=1)

    def b(x, p):
        b3 = bc(x, p["branch3x3"], stride=2)
        bd = bc(bc(x, p["branch3x3dbl_1"]), p["branch3x3dbl_2"], padding=(1, 1))
        return torch.cat([b3, bc(bd, p["branch3x3dbl_3"], stride=2), mp(x)], dim=1)

    def c(x, p):
        b7 = bc(bc(x, p["branch7x7_1"]), p["branch7x7_2"], padding=(0, 3))
        b7 = bc(b7, p["branch7x7_3"], padding=(3, 0))
        bd = bc(bc(x, p["branch7x7dbl_1"]), p["branch7x7dbl_2"], padding=(3, 0))
        bd = bc(bc(bd, p["branch7x7dbl_3"], padding=(0, 3)), p["branch7x7dbl_4"], padding=(3, 0))
        bd = bc(bd, p["branch7x7dbl_5"], padding=(0, 3))
        return torch.cat([bc(x, p["branch1x1"]), b7, bd, bc(ap(x), p["branch_pool"])], dim=1)

    def d(x, p):
        b3 = bc(bc(x, p["branch3x3_1"]), p["branch3x3_2"], stride=2)
        b7 = bc(bc(x, p["branch7x7x3_1"]), p["branch7x7x3_2"], padding=(0, 3))
        b7 = bc(bc(b7, p["branch7x7x3_3"], padding=(3, 0)), p["branch7x7x3_4"], stride=2)
        return torch.cat([b3, b7, mp(x)], dim=1)

    def e(x, p, pool):
        b3 = bc(x, p["branch3x3_1"])
        b3 = torch.cat([bc(b3, p["branch3x3_2a"], padding=(0, 1)),
                        bc(b3, p["branch3x3_2b"], padding=(1, 0))], dim=1)
        bd = bc(bc(x, p["branch3x3dbl_1"]), p["branch3x3dbl_2"], padding=(1, 1))
        bd = torch.cat([bc(bd, p["branch3x3dbl_3a"], padding=(0, 1)),
                        bc(bd, p["branch3x3dbl_3b"], padding=(1, 0))], dim=1)
        bp = ap(x) if pool == "avg" else mp(x, k=3, stride=1, padding=1)
        return torch.cat([bc(x, p["branch1x1"]), b3, bd, bc(bp, p["branch_pool"])], dim=1)

    return {"inception_a": a, "inception_b": b, "inception_c": c, "inception_d": d,
            "inception_e": e}


BLOCKS = {
    "a": (inc._a_spec("blk", 192, 32), 192, lambda m, x, p: m["inception_a"](x, p)),
    "b": (inc._b_spec("blk", 288), 288, lambda m, x, p: m["inception_b"](x, p)),
    "c": (inc._c_spec("blk", 768, 128), 768, lambda m, x, p: m["inception_c"](x, p)),
    "d": (inc._d_spec("blk", 768), 768, lambda m, x, p: m["inception_d"](x, p)),
    "e avg": (inc._e_spec("blk", 1280), 1280, lambda m, x, p: m["inception_e"](x, p, "avg")),
    "e max": (inc._e_spec("blk", 2048), 2048, lambda m, x, p: m["inception_e"](x, p, "max")),
}


@pytest.mark.parametrize("kind", list(BLOCKS))
def test_slices_of_the_block_output_equal_the_concatenation(kind):
    """Every block kind, its branches stored into channel slices of one
    output, equals ``torch.cat`` of the same branches bit for bit; so does
    the same block with every layer through the wrapper's plain path."""
    spec, c_in, call = BLOCKS[kind]
    params = {path.split(".", 1)[1]: leaf
              for path, leaf in leaves(random_state_dict(10, spec), spec).items()}
    x = torch.rand((2, c_in, 9, 9), generator=torch.Generator().manual_seed(11))
    new = {name: getattr(inc, name) for name in _cat_blocks()}
    want = call(_cat_blocks(), x, params)
    assert torch.equal(bits(call(new, x, params)), bits(want))
    original = inc.basic_conv
    inc.basic_conv = lambda x, p, stride=1, padding=(0, 0), out=None: ic.conv_bn_relu(
        x, p["layer"], stride, padding, out)
    try:
        assert torch.equal(bits(call(new, x, params)), bits(want))
    finally:
        inc.basic_conv = original


def test_the_plain_path_gives_the_graphs_features_bit_for_bit(monkeypatch):
    """The whole pool3 graph on the CPU at batch 2: features through the
    wrapper's plain path, with each block's branches in slices of its
    output, equal the graph with its blocks concatenated as they were and
    the graph's own primitives, bit for bit."""
    sd = random_state_dict(12)
    x = np.random.default_rng(13).random((2, 28, 28), dtype=np.float32)
    got = inc.make_inception_features(weights=sd, device="cpu")
    with monkeypatch.context() as m:
        m.setattr(inc, "basic_conv", lambda x, p, stride=1, padding=(0, 0), out=None:
                  ic.conv_bn_relu(x, p["layer"], stride, padding, out))
        plain = got(x)
    with monkeypatch.context() as m:
        for name, fn in _cat_blocks().items():
            m.setattr(inc, name, fn)
        before = got(x)
    assert got.batches == 2
    np.testing.assert_array_equal(plain.view(np.int32), before.view(np.int32))
    np.testing.assert_array_equal(got(x).view(np.int32), before.view(np.int32))
