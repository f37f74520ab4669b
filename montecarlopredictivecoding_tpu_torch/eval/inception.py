"""pytorch-fid's InceptionV3 pool3 feature graph, as functions on tensors.

The JAX package's ``eval/inception.py`` in torch: torchvision's InceptionV3
with pytorch-fid's FID-specific pooling (FIDInceptionA/C/E: the average pools
leave the zero padding out of the divisor; the last E block takes a max
pool), over a params tree whose paths mirror the torch ``state_dict``'s
module names, so the official FID weights, or any torchvision InceptionV3
checkpoint, load through :func:`load_torch_state_dict`.

No weights ship with the repository and nothing here downloads them:
:func:`make_inception_features` raises ``FileNotFoundError`` without
``weights=`` or ``$MCPC_INCEPTION_WEIGHTS``, and FID then uses the ResNet-9
or pixel features (``eval/fid.py``).  Random weights
(:func:`init_inception_params`) test the graph.

Input pipeline (pytorch_fid/inception.py): images in [0, 1], grey to RGB,
bilinear resize to 299x299 (half-pixel centres, no antialias), scaled to
[-1, 1].  Output: the 2048 pool3 features.  The convolutions run in full f32
(``full_f32_conv``), as the JAX package's run at ``Precision.HIGHEST``.

On the card every BasicConv2d (convolution, BatchNorm, relu) is one launch
of the hand-written kernel of ``ops/inception_conv.py`` (split-TF32 products
with f32 sums, the BatchNorm and relu in its epilogue), on channels-last
activations from the resize on, each branch stored straight into its
channel slice of the block's output.  On the CPU the graph runs the
primitives below (``conv2d``, ``batch_norm``) in the JAX package's layout;
the concatenations are the same copies into a block's output.
"""

from __future__ import annotations

import os
import typing as tp

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.inception_conv import ConvLayer, bn_vectors, conv_bn_relu, conv_layer, kernel_layout
from ..utils.precision import full_f32_conv

_BN_EPS = 1e-3  # torchvision BasicConv2d: BatchNorm2d(eps=0.001)


# -- primitives (NCHW / OIHW) ------------------------------------------------


def conv2d(x, w, stride=1, padding=(0, 0)):
    """A bias-free convolution with symmetric ``(ph, pw)`` zero padding."""
    padding = padding if isinstance(padding, tuple) else (padding, padding)
    return F.conv2d(x, w, None, stride, padding)


def batch_norm(x, p):
    """Eval-mode BatchNorm2d with running statistics."""
    scale, shift = bn_vectors(p["bn_w"], p["bn_b"], p["bn_m"], p["bn_v"], _BN_EPS)
    return x * scale[None, :, None, None] + shift[None, :, None, None]


def layer_of(p) -> ConvLayer:
    """A BasicConv2d's parameters as the kernel takes them (prepared once at
    load; a tree made some other way is prepared at each call)."""
    layer = p.get("layer")
    if layer is None:
        layer = conv_layer(p["w"], p["bn_w"], p["bn_b"], p["bn_m"], p["bn_v"], _BN_EPS)
    return layer


def basic_conv(x, p, stride=1, padding=(0, 0), out=None):
    """torchvision's BasicConv2d: bias-free conv -> BN(eps 1e-3) -> relu,
    into ``out`` (a channel slice of a block's output) where given."""
    if x.is_cuda:
        return conv_bn_relu(x, layer_of(p), stride, padding, out)
    y = torch.relu(batch_norm(conv2d(x, p["w"], stride, padding), p))
    return y if out is None else out.copy_(y)


def max_pool(x, k=3, stride=2, padding=0):
    return F.max_pool2d(x, k, stride, padding)


def avg_pool_excl(x, k=3, stride=1, padding=1):
    """AvgPool2d(count_include_pad=False): each window divides by the real
    elements it covers (pytorch-fid's fix)."""
    return F.avg_pool2d(x, k, stride, padding, count_include_pad=False)


def resize_bilinear(x, size):
    """Bilinear, half-pixel centres, no antialias (``align_corners=False``)."""
    return F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False)


# -- the blocks ----------------------------------------------------------------


def _width(p, name) -> int:
    return p[name]["w"].shape[0]


def _block_output(x, widths, size=None):
    """A block's output of ``x``'s batch, type, device and layout
    (channels-last on the card), ``size`` (H, W) or ``x``'s, uninitialised,
    and its channel slices of ``widths``: the branches' outputs, which
    together are their concatenation."""
    n, _, h, w = x.shape
    h, w = size or (h, w)
    out = torch.empty((n, sum(widths), h, w), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last if x.is_cuda else torch.contiguous_format)
    starts = np.cumsum((0,) + tuple(widths))
    return out, [out[:, a:b] for a, b in zip(starts[:-1], starts[1:])]


def _halved(x):
    """The size a 3x3 stride-2 convolution or pool without padding gives."""
    return (x.shape[2] - 3) // 2 + 1, (x.shape[3] - 3) // 2 + 1


def inception_a(x, p):
    out, (o1, o5, o3, op) = _block_output(x, [_width(p, "branch1x1"), _width(p, "branch5x5_2"),
                                              _width(p, "branch3x3dbl_3"),
                                              _width(p, "branch_pool")])
    basic_conv(x, p["branch1x1"], out=o1)
    b5 = basic_conv(x, p["branch5x5_1"])
    basic_conv(b5, p["branch5x5_2"], padding=(2, 2), out=o5)
    b3 = basic_conv(x, p["branch3x3dbl_1"])
    b3 = basic_conv(b3, p["branch3x3dbl_2"], padding=(1, 1))
    basic_conv(b3, p["branch3x3dbl_3"], padding=(1, 1), out=o3)
    basic_conv(avg_pool_excl(x), p["branch_pool"], out=op)
    return out


def inception_b(x, p):
    out, (o3, od, op) = _block_output(x, [_width(p, "branch3x3"), _width(p, "branch3x3dbl_3"),
                                          x.shape[1]], _halved(x))
    basic_conv(x, p["branch3x3"], stride=2, out=o3)
    bd = basic_conv(x, p["branch3x3dbl_1"])
    bd = basic_conv(bd, p["branch3x3dbl_2"], padding=(1, 1))
    basic_conv(bd, p["branch3x3dbl_3"], stride=2, out=od)
    op.copy_(max_pool(x))
    return out


def inception_c(x, p):
    out, (o1, o7, od, op) = _block_output(x, [_width(p, "branch1x1"), _width(p, "branch7x7_3"),
                                              _width(p, "branch7x7dbl_5"),
                                              _width(p, "branch_pool")])
    basic_conv(x, p["branch1x1"], out=o1)
    b7 = basic_conv(x, p["branch7x7_1"])
    b7 = basic_conv(b7, p["branch7x7_2"], padding=(0, 3))
    basic_conv(b7, p["branch7x7_3"], padding=(3, 0), out=o7)
    bd = basic_conv(x, p["branch7x7dbl_1"])
    bd = basic_conv(bd, p["branch7x7dbl_2"], padding=(3, 0))
    bd = basic_conv(bd, p["branch7x7dbl_3"], padding=(0, 3))
    bd = basic_conv(bd, p["branch7x7dbl_4"], padding=(3, 0))
    basic_conv(bd, p["branch7x7dbl_5"], padding=(0, 3), out=od)
    basic_conv(avg_pool_excl(x), p["branch_pool"], out=op)
    return out


def inception_d(x, p):
    out, (o3, o7, op) = _block_output(x, [_width(p, "branch3x3_2"), _width(p, "branch7x7x3_4"),
                                          x.shape[1]], _halved(x))
    b3 = basic_conv(x, p["branch3x3_1"])
    basic_conv(b3, p["branch3x3_2"], stride=2, out=o3)
    b7 = basic_conv(x, p["branch7x7x3_1"])
    b7 = basic_conv(b7, p["branch7x7x3_2"], padding=(0, 3))
    b7 = basic_conv(b7, p["branch7x7x3_3"], padding=(3, 0))
    basic_conv(b7, p["branch7x7x3_4"], stride=2, out=o7)
    op.copy_(max_pool(x))
    return out


def inception_e(x, p, pool: str):
    """``pool='avg'``: FIDInceptionE_1 (Mixed_7b); ``'max'``:
    FIDInceptionE_2 (Mixed_7c), whose max pool matches the TF FID graph."""
    out, (o1, o3a, o3b, oda, odb, op) = _block_output(x, [
        _width(p, name) for name in ("branch1x1", "branch3x3_2a", "branch3x3_2b",
                                     "branch3x3dbl_3a", "branch3x3dbl_3b", "branch_pool")])
    basic_conv(x, p["branch1x1"], out=o1)
    b3 = basic_conv(x, p["branch3x3_1"])
    basic_conv(b3, p["branch3x3_2a"], padding=(0, 1), out=o3a)
    basic_conv(b3, p["branch3x3_2b"], padding=(1, 0), out=o3b)
    bd = basic_conv(x, p["branch3x3dbl_1"])
    bd = basic_conv(bd, p["branch3x3dbl_2"], padding=(1, 1))
    basic_conv(bd, p["branch3x3dbl_3a"], padding=(0, 1), out=oda)
    basic_conv(bd, p["branch3x3dbl_3b"], padding=(1, 0), out=odb)
    bp = avg_pool_excl(x) if pool == "avg" else max_pool(x, k=3, stride=1, padding=1)
    basic_conv(bp, p["branch_pool"], out=op)
    return out


def inception_pool3_features(params, x):
    """``x`` ``[N, 3, H, W]`` in [0, 1] -> the 2048 pool3 features ``[N,
    2048]``, resize and input normalisation included."""
    x = 2.0 * resize_bilinear(x, 299) - 1.0
    if x.is_cuda:
        x = kernel_layout(x)
    x = basic_conv(x, params["Conv2d_1a_3x3"], stride=2)
    x = basic_conv(x, params["Conv2d_2a_3x3"])
    x = basic_conv(x, params["Conv2d_2b_3x3"], padding=(1, 1))
    x = max_pool(x)
    x = basic_conv(x, params["Conv2d_3b_1x1"])
    x = basic_conv(x, params["Conv2d_4a_3x3"])
    x = max_pool(x)
    for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
        x = inception_a(x, params[name])
    x = inception_b(x, params["Mixed_6a"])
    for name in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
        x = inception_c(x, params[name])
    x = inception_d(x, params["Mixed_7a"])
    x = inception_e(x, params["Mixed_7b"], pool="avg")
    x = inception_e(x, params["Mixed_7c"], pool="max")
    return torch.mean(x, dim=(2, 3))  # adaptive average pool to 1x1


# -- architecture: (module path, in, out, (kh, kw)) of every conv ---------------


def _a_spec(name, c_in, pool):
    return [
        (f"{name}.branch1x1", c_in, 64, (1, 1)),
        (f"{name}.branch5x5_1", c_in, 48, (1, 1)),
        (f"{name}.branch5x5_2", 48, 64, (5, 5)),
        (f"{name}.branch3x3dbl_1", c_in, 64, (1, 1)),
        (f"{name}.branch3x3dbl_2", 64, 96, (3, 3)),
        (f"{name}.branch3x3dbl_3", 96, 96, (3, 3)),
        (f"{name}.branch_pool", c_in, pool, (1, 1)),
    ]


def _b_spec(name, c_in):
    return [
        (f"{name}.branch3x3", c_in, 384, (3, 3)),
        (f"{name}.branch3x3dbl_1", c_in, 64, (1, 1)),
        (f"{name}.branch3x3dbl_2", 64, 96, (3, 3)),
        (f"{name}.branch3x3dbl_3", 96, 96, (3, 3)),
    ]


def _c_spec(name, c_in, c7):
    return [
        (f"{name}.branch1x1", c_in, 192, (1, 1)),
        (f"{name}.branch7x7_1", c_in, c7, (1, 1)),
        (f"{name}.branch7x7_2", c7, c7, (1, 7)),
        (f"{name}.branch7x7_3", c7, 192, (7, 1)),
        (f"{name}.branch7x7dbl_1", c_in, c7, (1, 1)),
        (f"{name}.branch7x7dbl_2", c7, c7, (7, 1)),
        (f"{name}.branch7x7dbl_3", c7, c7, (1, 7)),
        (f"{name}.branch7x7dbl_4", c7, c7, (7, 1)),
        (f"{name}.branch7x7dbl_5", c7, 192, (1, 7)),
        (f"{name}.branch_pool", c_in, 192, (1, 1)),
    ]


def _d_spec(name, c_in):
    return [
        (f"{name}.branch3x3_1", c_in, 192, (1, 1)),
        (f"{name}.branch3x3_2", 192, 320, (3, 3)),
        (f"{name}.branch7x7x3_1", c_in, 192, (1, 1)),
        (f"{name}.branch7x7x3_2", 192, 192, (1, 7)),
        (f"{name}.branch7x7x3_3", 192, 192, (7, 1)),
        (f"{name}.branch7x7x3_4", 192, 192, (3, 3)),
    ]


def _e_spec(name, c_in):
    return [
        (f"{name}.branch1x1", c_in, 320, (1, 1)),
        (f"{name}.branch3x3_1", c_in, 384, (1, 1)),
        (f"{name}.branch3x3_2a", 384, 384, (1, 3)),
        (f"{name}.branch3x3_2b", 384, 384, (3, 1)),
        (f"{name}.branch3x3dbl_1", c_in, 448, (1, 1)),
        (f"{name}.branch3x3dbl_2", 448, 384, (3, 3)),
        (f"{name}.branch3x3dbl_3a", 384, 384, (1, 3)),
        (f"{name}.branch3x3dbl_3b", 384, 384, (3, 1)),
        (f"{name}.branch_pool", c_in, 192, (1, 1)),
    ]


def conv_spec() -> tp.List[tp.Tuple[str, int, int, tp.Tuple[int, int]]]:
    """(module path, in, out, kernel) of all 94 convs, in forward order."""
    spec = [
        ("Conv2d_1a_3x3", 3, 32, (3, 3)),
        ("Conv2d_2a_3x3", 32, 32, (3, 3)),
        ("Conv2d_2b_3x3", 32, 64, (3, 3)),
        ("Conv2d_3b_1x1", 64, 80, (1, 1)),
        ("Conv2d_4a_3x3", 80, 192, (3, 3)),
    ]
    spec += _a_spec("Mixed_5b", 192, 32)
    spec += _a_spec("Mixed_5c", 256, 64)
    spec += _a_spec("Mixed_5d", 288, 64)
    spec += _b_spec("Mixed_6a", 288)
    spec += _c_spec("Mixed_6b", 768, 128)
    spec += _c_spec("Mixed_6c", 768, 160)
    spec += _c_spec("Mixed_6d", 768, 160)
    spec += _c_spec("Mixed_6e", 768, 192)
    spec += _d_spec("Mixed_7a", 768)
    spec += _e_spec("Mixed_7b", 1280)
    spec += _e_spec("Mixed_7c", 2048)
    return spec


def _set_nested(params: dict, path: str, leaf: dict):
    parts = path.split(".")
    d = params
    for k in parts[:-1]:
        d = d.setdefault(k, {})
    d[parts[-1]] = leaf


def init_inception_params(generator: tp.Optional[torch.Generator] = None,
                          dtype=torch.float32, device="cuda") -> dict:
    """Random parameters of the production shapes, for tests: normal
    kernels of variance 1/fan_in drawn from ``generator`` in
    :func:`conv_spec` order, identity batch norms."""
    params: dict = {}
    for path, c_in, c_out, k in conv_spec():
        w = torch.randn((c_out, c_in) + k, generator=generator, dtype=dtype)
        w = w * (1.0 / np.sqrt(c_in * k[0] * k[1]))
        ones = torch.ones((c_out,), dtype=dtype, device=device)
        zeros = torch.zeros((c_out,), dtype=dtype, device=device)
        leaf = {"w": w.to(device), "bn_w": ones, "bn_b": zeros, "bn_m": zeros.clone(),
                "bn_v": ones.clone()}
        leaf["layer"] = layer_of(leaf)
        _set_nested(params, path, leaf)
    return params


def load_torch_state_dict(state: tp.Union[str, os.PathLike, tp.Mapping], device="cuda") -> dict:
    """A torchvision / pytorch-fid InceptionV3 ``state_dict`` (a
    ``torch.save`` file, a module, or a dict of tensors or arrays) as the
    params tree on ``device``.  Keys ``<module>.conv.weight`` and
    ``<module>.bn.{weight,bias,running_mean,running_var}``; the classifier,
    the aux head and ``num_batches_tracked`` are ignored.  Shapes are checked
    against :func:`conv_spec`."""
    if isinstance(state, (str, os.PathLike)):
        state = torch.load(state, map_location="cpu", weights_only=True)
    if hasattr(state, "state_dict"):
        state = state.state_dict()

    def arr(v):
        v = v.detach().cpu() if hasattr(v, "detach") else np.array(v)
        return torch.as_tensor(v, dtype=torch.float32).to(device)

    params: dict = {}
    for path, c_in, c_out, k in conv_spec():
        try:
            leaf = {
                "w": arr(state[f"{path}.conv.weight"]),
                "bn_w": arr(state[f"{path}.bn.weight"]),
                "bn_b": arr(state[f"{path}.bn.bias"]),
                "bn_m": arr(state[f"{path}.bn.running_mean"]),
                "bn_v": arr(state[f"{path}.bn.running_var"]),
            }
        except KeyError as e:
            raise KeyError(
                f"InceptionV3 state dict is missing {e.args[0]!r} — expected "
                "torchvision inception_v3 / pytorch-fid key layout"
            ) from None
        if tuple(leaf["w"].shape) != (c_out, c_in) + k:
            raise ValueError(
                f"{path}.conv.weight has shape {tuple(leaf['w'].shape)}, expected "
                f"{(c_out, c_in) + k}"
            )
        leaf["layer"] = layer_of(leaf)
        _set_nested(params, path, leaf)
    return params


WEIGHTS_ENV = "MCPC_INCEPTION_WEIGHTS"
DIGEST_CHARS = 12


def params_digest(params: dict) -> str:
    """The first ``DIGEST_CHARS`` hex digits of the sha256 of every
    parameter's float32 bytes, in :func:`conv_spec` order: the weights'
    name in the FID statistics' cache files."""
    import hashlib

    h = hashlib.sha256()
    for path, *_ in conv_spec():
        leaf = params
        for k in path.split("."):
            leaf = leaf[k]
        for k in ("w", "bn_w", "bn_b", "bn_m", "bn_v"):
            h.update(leaf[k].detach().to("cpu", torch.float32).contiguous().numpy().tobytes())
    return h.hexdigest()[:DIGEST_CHARS]


def make_inception_features(weights: tp.Union[str, tp.Mapping, None] = None,
                            batch_size: int = 64, device="cuda"):
    """FID feature extractor: ``[N, 28, 28]`` images in [0, 1] -> ``[N,
    2048]`` numpy features, computed on ``device`` in batches, each read
    back as it ends.

    ``weights``: a torch InceptionV3 state dict or its file; defaults to
    ``$MCPC_INCEPTION_WEIGHTS``.  Raises ``FileNotFoundError`` when there are
    none; it never downloads.  The function's ``tag`` is ``"inception-"``
    and the weights' :func:`params_digest`, so statistics cached for one
    set of weights are never read for another; its ``device`` tells
    ``eval/fid.py`` where to compute the moments; ``batches`` counts the
    batches it ran (assign 0 to reset it)."""
    if weights is None:
        weights = os.environ.get(WEIGHTS_ENV)
    if weights is None:
        raise FileNotFoundError(
            "no InceptionV3 weights: set $MCPC_INCEPTION_WEIGHTS to a torch "
            "state-dict file (e.g. pytorch-fid's pt_inception weights) or "
            "pass weights=; offline runs use the ResNet-9/pixel extractors"
        )
    if isinstance(weights, (str, os.PathLike)) and not os.path.isfile(weights):
        raise FileNotFoundError(f"InceptionV3 weights not found: {weights}")
    params = load_torch_state_dict(weights, device)

    def fn(images: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.asarray(images, np.float32).reshape(-1, 1, 28, 28))
        out = []
        with torch.no_grad(), full_f32_conv():
            for s in range(0, len(x), batch_size):
                xb = x[s : s + batch_size].to(device).expand(-1, 3, -1, -1)  # grey -> RGB
                out.append(inception_pool3_features(params, xb).cpu().numpy())
                fn.batches += 1
        return np.concatenate(out, axis=0)

    fn.tag = "inception-" + params_digest(params)
    fn.device = torch.device(device)
    fn.batches = 0
    return fn
