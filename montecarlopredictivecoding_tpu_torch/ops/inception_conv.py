"""InceptionV3's BasicConv2d (bias-free convolution -> eval BatchNorm, eps
1e-3 -> relu) as one hand-written kernel: its wrapper, its plain PyTorch
version, and what both take from a layer's weights once, at load.

On CUDA tensors :func:`conv_bn_relu` launches ``csrc/inception_conv.cu``:
an implicit-GEMM convolution on the tensor cores whose products are
split-TF32 (each f32 operand as a TF32 high part and a TF32 low part,
three products a product, f32 sums), with the BatchNorm as a per-channel
scale and shift and the relu in its epilogue, stored once, optionally into
a channel slice of a block's concatenated output.  It replaces no TPU
kernel: the JAX package convolves with ``lax.conv_general_dilated`` at
``Precision.HIGHEST``, which the split plays the part of.  On CPU tensors
it runs :func:`conv_bn_relu_reference`, the same function in plain PyTorch
(full f32 convolution, then the BatchNorm's vectors, then relu).  There is
no fallback from one to the other.

Layout.  The kernel reads channels-last activations whose channel count is
a multiple of 4 (:func:`kernel_layout` makes the network's input so) and
writes channels-last outputs.  :func:`conv_layer` prepares a layer once:
the BatchNorm's ``scale`` and ``shift`` by the formula of
``eval/inception.batch_norm``, and the weights re-laid out as
``[C_out][kh][kw][C_in]`` (channels padded to the input's), K padded to a
whole tile, split into TF32 hi and lo (:func:`split_tf32`) and arranged as
the kernel's shared-memory stages, one bulk copy each
(:func:`pack_weights`).

The tile is chosen from the shapes the kernel sees (:func:`tile_for`).
``conv_bn_relu.launches`` counts launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import typing as tp

import torch
import torch.nn.functional as F

from ..utils.precision import full_f32_conv
from .mcpc_chain import _device_index, _on, _raw_stream

Tensor = torch.Tensor

K_TILE = 32           # the kernel's BK
CHANNEL_ALIGN = 4     # a 16-byte copy is 4 channels of one tap
SMS = 132             # H100 SXM
_N_TILES = (32, 64, 96, 128)
_TILE_COST = 32       # columns' worth of per-tile work (the A tile's copy and split)
_WAVES = 4            # 128-row blocks over one wave and under this many: 64-row blocks

_P = ctypes.c_void_p
_I = ctypes.c_int


def tf32_round(x: Tensor) -> Tensor:
    """f32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as the kernel rounds: its low 13 bits zero (in ``x``'s
    memory layout)."""
    bits = x.view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: Tensor) -> tp.Tuple[Tensor, Tensor]:
    """``(hi, lo)``: ``hi`` is ``x`` rounded to TF32, ``lo`` the rounding of
    ``x - hi`` (exact in f32); ``hi + lo`` is ``x`` to about 2^-22."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def padded_channels(c: int) -> int:
    return -(-c // CHANNEL_ALIGN) * CHANNEL_ALIGN


def n_tile(c_out: int) -> int:
    """The kernel's column tile for ``c_out`` output channels: 32, 64, 96
    or 128, whichever wastes least with each tile's own work counted as
    ``_TILE_COST`` more columns (the larger on a tie)."""
    return min(_N_TILES, key=lambda b: (-(-c_out // b) * (b + _TILE_COST), -b))


def pack_weights(w: Tensor) -> Tensor:
    """OIHW f32 weights -> the kernel's B stages, ``[C_out / bn, k_tiles *
    bn * 2 * K_TILE]`` for ``bn = n_tile(C_out)``.

    K runs over (kh, kw, C_in padded to a multiple of 4) and is padded with
    zeros to whole tiles of ``K_TILE``; C_out is padded with zero rows to
    whole blocks of ``bn``.  A block's K tile is ``[hi, lo][K_TILE / 4][bn]
    [4]``: for each 4 K values, the ``bn`` rows' 16 bytes one after
    another, so 8 rows of one chunk are a wgmma core matrix."""
    c_out, c_in, kh, kw = w.shape
    w = F.pad(w.permute(0, 2, 3, 1), (0, padded_channels(c_in) - c_in))
    w = w.reshape(c_out, -1)
    w = F.pad(w, (0, -(-w.shape[1] // K_TILE) * K_TILE - w.shape[1])).contiguous()
    bn = n_tile(c_out)
    blocks, k_tiles = -(-c_out // bn), w.shape[1] // K_TILE
    halves = torch.stack(split_tf32(w), 1).view(c_out, 2, k_tiles, K_TILE // 4, 4)
    halves = F.pad(halves, (0, 0, 0, 0, 0, 0, 0, 0, 0, blocks * bn - c_out))
    stages = halves.view(blocks, bn, 2, k_tiles, K_TILE // 4, 4).permute(0, 3, 2, 4, 1, 5)
    return stages.reshape(blocks, -1).contiguous()


@dataclasses.dataclass(frozen=True)
class ConvLayer:
    """One BasicConv2d as the kernel and its plain version take it."""

    w: Tensor        # OIHW, as loaded (the plain version's)
    scale: Tensor    # [C_out]: bn_w * rsqrt(bn_v + eps)
    shift: Tensor    # [C_out]: bn_b - bn_m * bn_w * rsqrt(bn_v + eps)
    packed: Tensor   # pack_weights(w)

    @property
    def c_out(self) -> int:
        return self.w.shape[0]

    @property
    def c_in(self) -> int:
        return self.w.shape[1]

    @property
    def kernel_size(self) -> tp.Tuple[int, int]:
        return self.w.shape[2], self.w.shape[3]


def bn_vectors(bn_w: Tensor, bn_b: Tensor, bn_m: Tensor, bn_v: Tensor,
               eps: float) -> tp.Tuple[Tensor, Tensor]:
    """Eval BatchNorm as ``x * scale + shift``: the vectors, each element
    rounded as ``eval/inception.batch_norm`` rounds it."""
    inv = torch.rsqrt(bn_v + eps)
    return bn_w * inv, bn_b - bn_m * bn_w * inv


def conv_layer(w: Tensor, bn_w: Tensor, bn_b: Tensor, bn_m: Tensor, bn_v: Tensor,
               eps: float) -> ConvLayer:
    """A layer's weights and BatchNorm, prepared once on their device."""
    scale, shift = bn_vectors(bn_w, bn_b, bn_m, bn_v, eps)
    return ConvLayer(w=w, scale=scale.contiguous(), shift=shift.contiguous(),
                     packed=pack_weights(w.float()))


def output_size(h: int, w: int, kernel: tp.Tuple[int, int], stride: int,
                padding: tp.Tuple[int, int]) -> tp.Tuple[int, int]:
    return ((h + 2 * padding[0] - kernel[0]) // stride + 1,
            (w + 2 * padding[1] - kernel[1]) // stride + 1)


def tile_for(m: int, c_out: int) -> tp.Tuple[int, int]:
    """``(bm, bn)``: C_out in :func:`n_tile` columns; M in 128 rows (two
    warpgroups, one block an SM), or 64 (one warpgroup, two blocks an SM)
    where 128 would make more than one wave of blocks and fewer than
    ``_WAVES``: there the smaller blocks even out the last wave.  (On the
    card, 64-row blocks won 4-11% on the 17 x 17 stage's layers and lost
    25% on the 8 x 8 stage's, whose 128-row blocks fit in one wave.)"""
    bn = n_tile(c_out)
    blocks = -(-m // 128) * -(-c_out // bn)
    return (64 if SMS < blocks < _WAVES * SMS else 128), bn


def kernel_layout(x: Tensor) -> Tensor:
    """``[N, C, H, W]`` -> the same values channels-last, with zero channels
    up to a multiple of 4 (the network's 3-channel input), as the kernel
    reads them."""
    n, c, h, w = x.shape
    cp = padded_channels(c)
    if cp == c:
        return x.contiguous(memory_format=torch.channels_last)
    out = torch.zeros((n, h, w, cp), dtype=x.dtype, device=x.device)
    out[..., :c] = x.permute(0, 2, 3, 1)
    return out.permute(0, 3, 1, 2)


def conv_bn_relu_reference(x: Tensor, layer: ConvLayer, stride: int = 1,
                           padding: tp.Tuple[int, int] = (0, 0)) -> Tensor:
    """The plain version: a full-f32 convolution, the BatchNorm's vectors,
    relu.  A channel-padded input takes the padding's zero weights."""
    w = layer.w
    if x.shape[1] != w.shape[1]:
        w = F.pad(w, (0, 0, 0, 0, 0, x.shape[1] - w.shape[1]))
    with full_f32_conv():
        y = F.conv2d(x, w, None, stride, padding)
    return torch.relu(y * layer.scale[None, :, None, None] + layer.shift[None, :, None, None])


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from . import _build

    lib = _build.load("inception_conv")
    lib.inception_conv_launch.restype = _I
    lib.inception_conv_launch.argtypes = [_P] * 5 + [_I] * 15 + [_P]
    lib.inception_conv_k_tile.restype = _I
    lib.inception_conv_k_tile.argtypes = []
    lib.inception_conv_error_string.restype = ctypes.c_char_p
    lib.inception_conv_error_string.argtypes = [_I]
    if lib.inception_conv_k_tile() != K_TILE:
        raise RuntimeError("the library's K tile is not the weight layout's")
    return lib


def _channel_stride(t: Tensor) -> tp.Optional[int]:
    """The channel count of the channels-last buffer ``t`` ([N, C, H, W])
    is a channel slice of, or None when ``t`` is no such slice."""
    n, c, h, w = t.shape
    sn, sc, sh, sw = t.stride()
    if sc != 1 or sw < c or sh != sw * w or sn != sh * h:
        return None
    return sw


def conv_bn_relu(x: Tensor, layer: ConvLayer, stride: int = 1,
                 padding: tp.Tuple[int, int] = (0, 0), out: tp.Optional[Tensor] = None) -> Tensor:
    """relu(BatchNorm(conv(x))) of one layer, into ``out`` where given (an
    ``[N, C_out, P, Q]`` view, e.g. a channel slice of a block's output).

    CUDA: ``x`` f32 ``[N, C, H, W]`` channels-last with C the layer's input
    channels padded to a multiple of 4, ``out`` a channels-last channel
    slice with an even offset and channel stride (a fresh channels-last
    tensor without it); launches the kernel or raises.  CPU: the plain
    version, copied into ``out`` where given."""
    padding = padding if isinstance(padding, tuple) else (padding, padding)
    if x.dim() != 4:
        raise ValueError(f"conv_bn_relu takes [N, C, H, W], got {tuple(x.shape)}")
    n, c, h, w = x.shape
    p, q = output_size(h, w, layer.kernel_size, stride, padding)
    shape = (n, layer.c_out, p, q)
    if out is not None and tuple(out.shape) != shape:
        raise ValueError(f"out is {tuple(out.shape)}, the layer gives {shape}")
    if x.device.type == "cpu":
        y = conv_bn_relu_reference(x, layer, stride, padding)
        return y if out is None else out.copy_(y)
    if x.device.type != "cuda":
        raise ValueError(f"conv_bn_relu runs on cpu or cuda, not {x.device.type}")
    if x.dtype != torch.float32:
        raise TypeError(f"conv_bn_relu takes float32, got {x.dtype}")
    if c != padded_channels(layer.c_in):
        raise ValueError(f"the layer takes {layer.c_in} channels padded to "
                         f"{padded_channels(layer.c_in)}, x has {c}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("conv_bn_relu takes a channels-last contiguous x")
    for t in (layer.packed, layer.scale, layer.shift):
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("the layer's tensors are not contiguous float32 on x's device")
    if out is None:
        out = torch.empty(shape, dtype=x.dtype, device=x.device,
                          memory_format=torch.channels_last)
    ctot = _channel_stride(out)
    if out.device != x.device or out.dtype != torch.float32 or ctot is None:
        raise ValueError("out is not a float32 channels-last channel slice on x's device")
    if layer.c_out % 2 or ctot % 2 or out.storage_offset() % ctot % 2:
        raise ValueError("the kernel stores channel pairs: C_out, the slice's offset and "
                         "its channel stride must be even")
    if n * h * w * c >= 2**31 or n * p * q * ctot >= 2**31:
        raise ValueError("the kernel indexes with 32-bit offsets")
    bm, bn = tile_for(n * p * q, layer.c_out)
    k_tiles = math.ceil(layer.kernel_size[0] * layer.kernel_size[1] * c / K_TILE)
    if layer.packed.shape != (-(-layer.c_out // bn), k_tiles * bn * 2 * K_TILE):
        raise ValueError("the layer's packed weights do not match x's channels")
    index = _device_index(x.device)
    with _on(index):
        err = _library().inception_conv_launch(
            x.data_ptr(), layer.packed.data_ptr(), layer.scale.data_ptr(), layer.shift.data_ptr(),
            out.data_ptr(), n, h, w, c, p, q, layer.kernel_size[0], layer.kernel_size[1], stride,
            padding[0], padding[1], layer.c_out, ctot, bm, bn, _raw_stream(index))
    if err != 0:
        raise RuntimeError("inception_conv kernel launch failed: "
                           f"{_library().inception_conv_error_string(err).decode()} ({err})")
    conv_bn_relu.launches += 1
    return out


conv_bn_relu.launches = 0
