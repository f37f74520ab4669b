"""Checkpoints: the native format, and the torch state-dict shims for the
generative MLP, the DLGM and ResNet-9.

The native format is the JAX package's: flax's msgpack serialization of a
params pytree.  A tuple or list is a map keyed ``"0"``, ``"1"``, ...; a dict
is a map of its (sorted) keys; an array is the ext type 1 holding a packed
``(shape, dtype name, C-order bytes)``.  So a file written here loads in the
JAX package and the JAX package's ``models/*.msgpack`` load here.  Neither
``flax`` nor ``msgpack`` is needed: this module reads and writes the subset
of msgpack that those files use (nil, bool, int, float, str, bin, array,
map, ext).

The MLP's shims map the reference's ``torch.save(state_dict)`` layout (keys
``"<module_idx>.weight"`` / ``".bias"``, weights ``[out, in]``) onto the
params tuple (weights ``[in, out]``) and back.  The DLGM's map the
reference's DLGM files onto ``(gen_params, rec_params)`` and back; a native
DLGM file is that tuple, stored as ``{"0", "1"}``.  ResNet-9's map the
reference's torch layout, which the port's module uses, onto the flax
variables of ``models/resnet9.msgpack`` and back.
"""

from __future__ import annotations

import os
import re
import struct
import typing as tp

import numpy as np
import torch

if tp.TYPE_CHECKING:  # annotations only: utils imports nothing of the package
    from ..core.model import PCModel

_EXT_NDARRAY = 1
# the array types a params pytree holds
_DTYPES = ("float32", "float64", "int32", "int64")


# ----------------------------------------------------------- msgpack, write


def _pack_int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return struct.pack("B", n)
    if -32 <= n < 0:
        return struct.pack("b", n)
    for code, fmt, lo, hi in (
        (0xCC, ">B", 0, 2**8), (0xCD, ">H", 0, 2**16), (0xCE, ">I", 0, 2**32),
        (0xCF, ">Q", 0, 2**64), (0xD0, ">b", -2**7, 0), (0xD1, ">h", -2**15, 0),
        (0xD2, ">i", -2**31, 0), (0xD3, ">q", -2**63, 0),
    ):
        if lo <= n < hi:
            return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"{n} does not fit a msgpack integer")


def _pack_head(n: int, fix: tp.Optional[tp.Tuple[int, int]], codes) -> bytes:
    """Header of a sized type: ``fix = (base, limit)`` for the one-byte form,
    ``codes`` the (code, struct format, limit) of the longer ones."""
    if fix is not None and n < fix[1]:
        return bytes([fix[0] | n])
    for code, fmt, limit in codes:
        if n < limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"{n} items do not fit a msgpack header")


def _pack_str(s: str) -> bytes:
    raw = s.encode("utf-8")
    return _pack_head(len(raw), (0xA0, 32), (
        (0xD9, ">B", 2**8), (0xDA, ">H", 2**16), (0xDB, ">I", 2**32))) + raw


def _pack_bin(raw: bytes) -> bytes:
    return _pack_head(len(raw), None, (
        (0xC4, ">B", 2**8), (0xC5, ">H", 2**16), (0xC6, ">I", 2**32))) + raw


def _pack_ext(kind: int, raw: bytes) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(raw) in fixed:
        head = bytes([fixed[len(raw)]])
    else:
        head = _pack_head(len(raw), None, (
            (0xC7, ">B", 2**8), (0xC8, ">H", 2**16), (0xC9, ">I", 2**32)))
    return head + struct.pack("b", kind) + raw


def _pack_array(arr: np.ndarray) -> bytes:
    if arr.dtype.name not in _DTYPES:
        raise TypeError(f"checkpoints hold {_DTYPES} arrays, not {arr.dtype.name}")
    body = _pack_head(3, (0x90, 16), ())
    body += _pack_head(arr.ndim, (0x90, 16), ((0xDC, ">H", 2**16),))
    body += b"".join(_pack_int(int(d)) for d in arr.shape)
    body += _pack_str(arr.dtype.name) + _pack_bin(arr.tobytes("C"))
    return _pack_ext(_EXT_NDARRAY, body)


def _pack(obj) -> bytes:
    """msgpack bytes of a pytree of dicts, tuples, lists, tensors, arrays and
    Python scalars, as flax's ``to_bytes`` writes it."""
    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu().numpy()
    if isinstance(obj, np.ndarray):
        return _pack_array(obj)
    if isinstance(obj, (tuple, list)):
        obj = {str(i): v for i, v in enumerate(obj)}
    if isinstance(obj, dict):
        if not all(isinstance(k, str) for k in obj):
            raise TypeError("checkpoint dicts need string keys")
        # a tuple's keys keep their order; a dict's are sorted, as the JAX
        # package's tree_map leaves them
        head = _pack_head(len(obj), (0x80, 16), (
            (0xDE, ">H", 2**16), (0xDF, ">I", 2**32)))
        return head + b"".join(_pack_str(k) + _pack(v) for k, v in obj.items())
    if obj is None:
        return b"\xc0"
    if isinstance(obj, bool):
        return b"\xc3" if obj else b"\xc2"
    if isinstance(obj, int):
        return _pack_int(obj)
    if isinstance(obj, float):
        return b"\xcb" + struct.pack(">d", obj)
    if isinstance(obj, str):
        return _pack_str(obj)
    raise TypeError(f"cannot write {type(obj).__name__} to a checkpoint")


def _sorted_dicts(tree):
    """The tree with every dict's keys sorted (tuples and lists keep their
    order)."""
    if isinstance(tree, dict):
        return {k: _sorted_dicts(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_sorted_dicts(v) for v in tree)
    return tree


# ------------------------------------------------------------ msgpack, read


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if n < 0 or self.pos + n > len(self.data):
            raise ValueError("checkpoint is cut short")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def number(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def ext(self, n: int):
        kind = self.number("b")
        raw = self.take(n)
        if kind != _EXT_NDARRAY:
            raise ValueError(f"unsupported msgpack ext type {kind}")
        shape, dtype, buf = _Reader(raw).value()
        if dtype not in _DTYPES:
            raise ValueError(f"unsupported array type {dtype!r} in checkpoint")
        # a copy: the result owns its memory and is writable
        return np.frombuffer(buf, dtype=dtype).reshape(shape).copy()

    def value(self):
        c = self.number("B")
        if c < 0x80:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.value() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return str(self.take(c & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if c in numbers:
            return self.number(numbers[c])
        sizes = {0: ">B", 1: ">H", 2: ">I"}
        if 0xC4 <= c <= 0xC6:
            return bytes(self.take(self.number(sizes[c - 0xC4])))
        if 0xC7 <= c <= 0xC9:
            return self.ext(self.number(sizes[c - 0xC7]))
        if 0xD4 <= c <= 0xD8:
            return self.ext(1 << (c - 0xD4))
        if 0xD9 <= c <= 0xDB:
            return str(self.take(self.number(sizes[c - 0xD9])), "utf-8")
        if c in (0xDC, 0xDD):
            return [self.value() for _ in range(self.number(sizes[c - 0xDB]))]
        if c in (0xDE, 0xDF):
            return self.map(self.number(sizes[c - 0xDD]))
        raise ValueError(f"unsupported msgpack type byte 0x{c:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def _unpack(data: bytes):
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(data):
        raise ValueError("checkpoint has bytes after its end")
    return out


def _restore(like, state, device, where: str):
    """``state`` (maps and arrays as read) in the structure of ``like``."""
    if isinstance(like, (tuple, list)):
        keys = [str(i) for i in range(len(like))]
        if not isinstance(state, dict) or sorted(state) != sorted(keys):
            raise ValueError(f"checkpoint{where} does not hold {len(like)} items")
        return type(like)(
            _restore(v, state[k], device, f"{where}[{k}]") for k, v in zip(keys, like))
    if isinstance(like, dict):
        if not isinstance(state, dict) or set(state) != set(like):
            got = sorted(state) if isinstance(state, dict) else type(state).__name__
            raise ValueError(
                f"checkpoint{where} holds {got}, expected keys {sorted(like)}")
        return {k: _restore(v, state[k], device, f"{where}[{k!r}]")
                for k, v in like.items()}
    if isinstance(state, np.ndarray):
        return torch.from_numpy(state).to(device)
    return state


# -------------------------------------------------------------- public API


def save_checkpoint(path: str, pytree) -> None:
    """Write ``pytree`` (tuples, lists and dicts of tensors or numpy arrays)
    in the native format."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    data = _pack(_sorted_dicts(pytree))
    with open(path, "wb") as f:
        f.write(data)


def load_checkpoint(path: str, like, device="cuda") -> tp.Any:
    """Load a native checkpoint; ``like`` is a pytree with the target
    structure (for example ``model.init(...)``), whose leaves are not read.
    Arrays come back as tensors on ``device``, with the file's types.  A file
    whose structure differs from ``like`` is a ``ValueError``."""
    with open(path, "rb") as f:
        data = f.read()
    return _restore(like, _unpack(data), device, "")


def torch_state_dict_to_params(
    state_dict: tp.Mapping[str, tp.Any],
    model: tp.Optional[PCModel] = None,
    device="cuda",
) -> tuple:
    """Convert a reference-style Sequential state dict to a params tuple.

    Keys ``"<i>.weight"`` are gathered in ascending module index; stale
    ``"<i>._x"`` latent entries are ignored (the reference loads with
    ``strict=False`` for the same reason).
    """
    weights: tp.Dict[int, torch.Tensor] = {}
    biases: tp.Dict[int, torch.Tensor] = {}
    for k, v in state_dict.items():
        m = re.fullmatch(r"(\d+)\.(weight|bias)", k)
        if not m:
            continue  # e.g. "1._x" stale latents
        (weights if m.group(2) == "weight" else biases)[int(m.group(1))] = (
            torch.as_tensor(v).detach())

    params = []
    for idx in sorted(weights):
        # torch [out, in] -> ours [in, out]
        p = {"w": weights[idx].t().contiguous().to(device)}
        if idx in biases:
            p["b"] = biases[idx].clone().to(device)
        params.append(p)

    if model is not None:
        expected = [
            (model.modules[i].in_dim, model.modules[i].out_dim)
            for i in model.linear_indices
        ]
        got = [tuple(p["w"].shape) for p in params]
        if expected != got:
            raise ValueError(
                f"checkpoint shapes {got} do not match model Linears {expected}"
            )
    return tuple(params)


def load_torch_state_dict(path: str, model: tp.Optional[PCModel] = None,
                          device="cuda") -> tuple:
    """Load a reference torch checkpoint file into a params tuple."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return torch_state_dict_to_params(sd, model, device)


def params_to_torch_state_dict(model: PCModel, params) -> dict:
    """Inverse of :func:`torch_state_dict_to_params`: the reference's
    Sequential key layout (``"<module_idx>.weight"`` / ``".bias"``, weights
    ``[out, in]``, CPU tensors) for a params tuple.  A Linear's position in
    ``model.modules`` is its torch module index, so the result loads into
    the reference code unchanged."""
    if len(model.linear_indices) != len(params):
        raise ValueError(
            f"params tuple has {len(params)} entries for "
            f"{len(model.linear_indices)} Linear modules"
        )
    sd = {}
    for idx, p in zip(model.linear_indices, params):
        sd[f"{idx}.weight"] = p["w"].detach().cpu().t().contiguous()
        if "b" in p:
            sd[f"{idx}.bias"] = p["b"].detach().cpu().clone()
    return sd


def save_torch_state_dict(path: str, model: PCModel, params) -> None:
    """Write a reference-loadable torch checkpoint for a params tuple."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(params_to_torch_state_dict(model, params), path)


def read_checkpoint(path: str) -> dict:
    """A native (flax-msgpack) file as it is stored: nested dicts of numpy
    arrays, tuples and lists as maps keyed ``"0"``, ``"1"``, ...  For files
    whose structure is not a params tuple, such as ResNet-9's ``{"params",
    "batch_stats"}`` variables."""
    with open(path, "rb") as f:
        return _unpack(f.read())


# ---------------------------------------------------------------- the DLGM


def _as_tensor(v, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v.detach().cpu() if hasattr(v, "detach") else v),
                           dtype=torch.float32).to(device)


def torch_dlgm_state_dict_to_params(state_dict: tp.Mapping[str, tp.Any], device="cuda"):
    """A reference DLGM checkpoint as ``(gen_params, rec_params)`` for
    :class:`..models.dlgm.DLGM`, weights ``[in, out]`` on ``device``.

    Both layouts the reference writes: the nested ``{"generative_model": sd,
    "recognition_model": sd}`` (flattened to dotted keys first) and flat
    dotted state dicts.  Both topologies: the simple one-level model
    (``fc3``/``fc4`` and ``fc1``/``fc21``/``fc22``), returned as ``({"fc3",
    "fc4"}, {"nets": [one net]})``, and the stacked one (``T_list``,
    ``final``, ``node_list.N``)."""
    if any(not hasattr(v, "shape") and isinstance(v, tp.Mapping)
           for v in state_dict.values()):
        flat = {}
        for top, sub in state_dict.items():
            if isinstance(sub, tp.Mapping):
                for k, v in sub.items():
                    flat[f"{top}.{k}"] = v
            else:
                flat[top] = sub
        state_dict = flat

    def linear(prefix):
        return {"w": _as_tensor(state_dict[prefix + ".weight"], device).t().contiguous(),
                "b": _as_tensor(state_dict[prefix + ".bias"], device)}

    def net(prefix):
        return {"fc1": linear(prefix + ".fc1"), "mu": linear(prefix + ".fc21"),
                "cov": linear(prefix + ".fc22")}

    if "generative_model.fc3.weight" in state_dict:
        gen = {"fc3": linear("generative_model.fc3"), "fc4": linear("generative_model.fc4")}
        return gen, {"nets": [net("recognition_model")]}

    T = []
    for k in sorted(state_dict):
        m = re.fullmatch(r"generative_model\.T_list\.(\d+)\.1\.weight", k)
        if m:
            i = int(m.group(1))
            while len(T) <= i:
                T.append({})
            T[i] = linear(f"generative_model.T_list.{i}.1")
    gen = {"T": T, "final": linear("generative_model.final.1")}
    if "generative_model.bias.bias" in state_dict:
        gen["bias"] = _as_tensor(state_dict["generative_model.bias.bias"], device)
    else:
        # the first T block's input width is the top latent's
        gen["bias"] = torch.zeros((T[0]["w"].shape[0],), device=device)
    nets = []
    while f"recognition_model.node_list.{len(nets)}.fc1.weight" in state_dict:
        nets.append(net(f"recognition_model.node_list.{len(nets)}"))
    return gen, {"nets": nets}


def load_torch_dlgm(path: str, device="cuda"):
    """A reference DLGM ``torch.save`` file as ``(gen_params, rec_params)``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return torch_dlgm_state_dict_to_params(sd, device)


def dlgm_params_to_torch_state_dict(gen_params, rec_params) -> dict:
    """A simple-topology DLGM (one latent level, ``fc3``/``fc4``) in the
    reference's nested save format, ``{"generative_model": sd,
    "recognition_model": sd}`` of CPU tensors, weights ``[out, in]``: the
    only topology the reference's evaluation reads."""
    if "fc3" not in gen_params:
        raise ValueError(
            "torch export covers the simple one-level DLGM topology "
            "(gen_params with fc3/fc4); the stacked one has no torch "
            "consumer in the reference"
        )

    def w(t):
        return t.detach().cpu().t().contiguous()

    def b(t):
        return t.detach().cpu().clone()

    net = rec_params["nets"][0]
    return {
        "generative_model": {
            "fc3.weight": w(gen_params["fc3"]["w"]), "fc3.bias": b(gen_params["fc3"]["b"]),
            "fc4.weight": w(gen_params["fc4"]["w"]), "fc4.bias": b(gen_params["fc4"]["b"]),
        },
        "recognition_model": {
            "fc1.weight": w(net["fc1"]["w"]), "fc1.bias": b(net["fc1"]["b"]),
            "fc21.weight": w(net["mu"]["w"]), "fc21.bias": b(net["mu"]["b"]),
            "fc22.weight": w(net["cov"]["w"]), "fc22.bias": b(net["cov"]["b"]),
        },
    }


# ---------------------------------------------------------------- ResNet-9

# the reference's torch module path of each conv block, in the call order of
# the flax model's ConvBlock_0..7 (the port's ResNet9 uses these names)
_RESNET9_BLOCKS = (
    "conv1", "conv2", "res1.0", "res1.1", "conv3", "conv4", "res2.0", "res2.1"
)


def _resnet9_feats_hw(is_mask: bool) -> tp.Tuple[int, int]:
    """Spatial shape of the map before the flatten, on MNIST inputs: full
    28x28 images end at 1x1; the masked variant's 14x28 bottom halves (no
    pool in conv4) at 1x3, hence its 768-wide head."""
    return (1, 3) if is_mask else (1, 1)


def _np(v) -> np.ndarray:
    return np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)


def resnet9_from_torch_state_dict(state_dict: tp.Mapping[str, tp.Any],
                                  is_mask: bool = False):
    """A torch ResNet-9 state dict (the reference's layout, which the port's
    :class:`..models.resnet9.ResNet9` uses) as flax variables ``(params,
    batch_stats)`` of numpy arrays, the layout of ``models/resnet9.msgpack``.

    Conv kernels go from torch ``[out, in, kh, kw]`` to flax ``[kh, kw, in,
    out]``; BatchNorm weight and bias become scale and bias, the running
    stats ``batch_stats``; the classifier's input order goes from torch's
    channel-major (NCHW) flatten to flax's NHWC flatten, an identity for the
    full image's 1x1 map but a permutation for the masked head's 1x3."""
    params: dict = {}
    stats: dict = {}
    for i, blk in enumerate(_RESNET9_BLOCKS):
        name = f"ConvBlock_{i}"
        params[name] = {
            "Conv_0": {"kernel": _np(state_dict[f"{blk}.0.weight"]).transpose(2, 3, 1, 0).copy(),
                       "bias": _np(state_dict[f"{blk}.0.bias"]).copy()},
            "BatchNorm_0": {"scale": _np(state_dict[f"{blk}.1.weight"]).copy(),
                            "bias": _np(state_dict[f"{blk}.1.bias"]).copy()},
        }
        stats[name] = {"BatchNorm_0": {"mean": _np(state_dict[f"{blk}.1.running_mean"]).copy(),
                                       "var": _np(state_dict[f"{blk}.1.running_var"]).copy()}}
    h, w = _resnet9_feats_hw(is_mask)
    cw = _np(state_dict["classifier.weight"])  # [classes, C*h*w], CHW order
    classes = cw.shape[0]
    params["Dense_0"] = {
        "kernel": cw.reshape(classes, -1, h, w).transpose(0, 2, 3, 1).reshape(classes, -1).T.copy(),
        "bias": _np(state_dict["classifier.bias"]).copy(),
    }
    return params, stats


def resnet9_to_torch_state_dict(params, batch_stats, is_mask: bool = False) -> dict:
    """Flax ResNet-9 variables (arrays or tensors) as the reference's torch
    state dict of CPU tensors, ``num_batches_tracked`` included, so it loads
    strictly into the reference's module and the port's."""
    def t(a):
        return torch.from_numpy(np.array(_np(a)))

    sd: dict = {}
    for i, blk in enumerate(_RESNET9_BLOCKS):
        name = f"ConvBlock_{i}"
        conv, bn = params[name]["Conv_0"], params[name]["BatchNorm_0"]
        run = batch_stats[name]["BatchNorm_0"]
        sd[f"{blk}.0.weight"] = t(_np(conv["kernel"]).transpose(3, 2, 0, 1))
        sd[f"{blk}.0.bias"] = t(conv["bias"])
        sd[f"{blk}.1.weight"] = t(bn["scale"])
        sd[f"{blk}.1.bias"] = t(bn["bias"])
        sd[f"{blk}.1.running_mean"] = t(run["mean"])
        sd[f"{blk}.1.running_var"] = t(run["var"])
        sd[f"{blk}.1.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    h, w = _resnet9_feats_hw(is_mask)
    kernel = _np(params["Dense_0"]["kernel"])  # [h*w*C, classes], HWC order
    classes = kernel.shape[1]
    sd["classifier.weight"] = t(
        kernel.T.reshape(classes, h, w, -1).transpose(0, 3, 1, 2).reshape(classes, -1))
    sd["classifier.bias"] = t(params["Dense_0"]["bias"])
    return sd


def load_resnet9_state_dict(path: str, is_mask: bool = False) -> dict:
    """A flax ResNet-9 file (``{"params": {ConvBlock_0..7, Dense_0},
    "batch_stats": ...}``, as ``models/resnet9.msgpack``) as a torch state
    dict."""
    raw = read_checkpoint(path)
    if set(raw) != {"params", "batch_stats"}:
        raise ValueError(f"{path} holds {sorted(raw)}, not ResNet-9 variables")
    return resnet9_to_torch_state_dict(raw["params"], raw["batch_stats"], is_mask)


def save_resnet9(path: str, state_dict: tp.Mapping[str, tp.Any], is_mask: bool = False) -> None:
    """Write a torch ResNet-9 state dict as flax variables, the file the JAX
    package's ``flax.serialization.from_bytes`` reads."""
    params, stats = resnet9_from_torch_state_dict(state_dict, is_mask)
    save_checkpoint(path, {"params": params, "batch_stats": stats})
