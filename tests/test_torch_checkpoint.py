"""The port's checkpoints (``utils/checkpoint.py``) against the JAX
package's: the native flax-msgpack format, read and written without flax or
msgpack, and the torch state-dict shims.  Everything is compared exactly:
a checkpoint is a copy of bytes."""

import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import montecarlopredictivecoding_tpu as mcpc
import montecarlopredictivecoding_tpu_torch as mt
from montecarlopredictivecoding_tpu.utils import checkpoint as jck
from montecarlopredictivecoding_tpu_torch.utils import checkpoint as tck
from montecarlopredictivecoding_tpu_torch.utils import params_from_numpy, params_to_numpy

torch.set_num_threads(1)

MODELS = Path(__file__).resolve().parents[1] / "models"
SHIPPED = {
    "mcpc_fid_tpu.msgpack": (20, 128, 128, 784),
    "mcpc_mse_1.msgpack": (10, 256, 256, 784),
}


def _like_np(dims):
    return jax.device_get(mcpc.make_mlp_model(*dims).init(jax.random.PRNGKey(0)))


def _random_params(dims=(4, 8, 8, 16), seed=0):
    rng = np.random.default_rng(seed)
    shapes = [(dims[0], dims[0]), (dims[0], dims[1]), (dims[1], dims[2]), (dims[2], dims[3])]
    return tuple({"w": rng.normal(size=s).astype(np.float32),
                  "b": rng.normal(size=s[1]).astype(np.float32)} for s in shapes)


def _assert_same(tparams, params_np):
    assert isinstance(tparams, tuple) and len(tparams) == len(params_np)
    for tp_, np_ in zip(tparams, params_np):
        assert set(tp_) == set(np_)
        for k in np_:
            assert tp_[k].dtype == torch.float32
            assert np.array_equal(tp_[k].numpy(), np.asarray(np_[k]))


@pytest.mark.parametrize("name", sorted(SHIPPED))
def test_port_loads_shipped_checkpoint_as_jax_does(name):
    dims = SHIPPED[name]
    like_np = _like_np(dims)
    want = jck.load_checkpoint(str(MODELS / name), like_np)
    got = tck.load_checkpoint(str(MODELS / name), params_from_numpy(like_np, "cpu"),
                              device="cpu")
    _assert_same(got, want)
    assert tuple(got[3]["w"].shape) == (dims[2], dims[3])
    # and writes it back byte for byte
    assert tck._pack(tck._sorted_dicts(got)) == (MODELS / name).read_bytes()


def test_port_file_loads_in_jax_and_jax_file_in_port(tmp_path):
    params_np = _random_params()
    # the port's {"w", "b"} key order differs from flax's sorted one
    tparams = tuple({"w": torch.from_numpy(p["w"]), "b": torch.from_numpy(p["b"])}
                    for p in params_np)
    tpath, jpath = str(tmp_path / "sub" / "port.msgpack"), str(tmp_path / "jax.msgpack")
    tck.save_checkpoint(tpath, tparams)
    jck.save_checkpoint(jpath, params_np)
    assert Path(tpath).read_bytes() == Path(jpath).read_bytes()
    back = jck.load_checkpoint(tpath, params_np)
    for a, b in zip(back, params_np):
        assert np.array_equal(a["w"], b["w"]) and np.array_equal(a["b"], b["b"])
    _assert_same(tck.load_checkpoint(jpath, tparams, device="cpu"), params_np)


def test_other_leaves_and_long_headers_round_trip_through_flax(tmp_path):
    """float64 and integer arrays, scalars, long strings, 20 items (map16)
    and an array above 64 KiB (bin32): the port's bytes are flax's."""
    from flax import serialization

    rng = np.random.default_rng(1)
    tree = {
        "count": 7, "neg": -300, "big": 2**40, "flag": True, "none": None,
        "rate": 0.25, "name": "x" * 40,
        "f64": rng.normal(size=(3, 2)), "i32": np.arange(5, dtype=np.int32),
        "i64": np.arange(4, dtype=np.int64).reshape(2, 2),
        "scalar": np.array(2.5, np.float32), "empty": np.zeros((0, 3), np.float32),
        "wide": rng.normal(size=(130, 130)).astype(np.float32),
        "many": [np.full(1, i, np.float32) for i in range(20)],
    }
    ours = tck._pack(tck._sorted_dicts(tree))
    assert ours == serialization.to_bytes(jax.tree_util.tree_map(lambda x: x, tree))
    path = str(tmp_path / "tree.msgpack")
    tck.save_checkpoint(path, tree)
    back = tck.load_checkpoint(path, tree, device="cpu")
    assert back["count"] == 7 and back["neg"] == -300 and back["big"] == 2**40
    assert back["flag"] is True and back["none"] is None and back["rate"] == 0.25
    assert back["name"] == "x" * 40 and isinstance(back["many"], list)
    for k in ("f64", "i32", "i64", "scalar", "empty", "wide"):
        assert back[k].dtype == torch.from_numpy(np.asarray(tree[k])).dtype
        assert np.array_equal(back[k].numpy(), tree[k])
    assert all(float(v) == i for i, v in enumerate(back["many"]))


def test_load_refuses_what_does_not_fit(tmp_path):
    params = params_from_numpy(_random_params(), "cpu")
    path = str(tmp_path / "p.msgpack")
    tck.save_checkpoint(path, params)
    with pytest.raises(ValueError, match="3 items"):
        tck.load_checkpoint(path, params[:3], device="cpu")
    with pytest.raises(ValueError, match="expected keys"):
        tck.load_checkpoint(path, tuple({"w": p["w"]} for p in params), device="cpu")
    data = Path(path).read_bytes()
    Path(path).write_bytes(data[:-10])
    with pytest.raises(ValueError, match="cut short"):
        tck.load_checkpoint(path, params, device="cpu")
    Path(path).write_bytes(data + b"\x00")
    with pytest.raises(ValueError, match="after its end"):
        tck.load_checkpoint(path, params, device="cpu")
    with pytest.raises(TypeError, match="arrays"):
        tck.save_checkpoint(path, {"h": torch.zeros(2, dtype=torch.float16)})


def test_state_dict_shims_round_trip_and_match_jax(tmp_path):
    dims = (4, 8, 8, 16)
    params_np = _random_params(dims)
    jmodel, tmodel = mcpc.make_mlp_model(*dims), mt.make_mlp_model(*dims)
    tparams = params_from_numpy(params_np, "cpu")
    sd = tck.params_to_torch_state_dict(tmodel, tparams)
    jsd = jck.params_to_torch_state_dict(jmodel, params_np)
    assert list(sd) == list(jsd) == [f"{i}.{k}" for i in (0, 3, 6, 9)
                                     for k in ("weight", "bias")]
    for k in sd:
        assert torch.equal(sd[k], jsd[k])
    assert tuple(sd["3.weight"].shape) == (8, 4)  # torch's [out, in]
    # stale latents are ignored, as the reference's strict=False load does
    sd_stale = dict(sd, **{"1._x": torch.zeros(2, 4)})
    back = tck.torch_state_dict_to_params(sd_stale, tmodel, device="cpu")
    _assert_same(back, params_np)
    _assert_same(back, params_from_numpy(
        jax.device_get(jck.torch_state_dict_to_params(sd_stale, jmodel)), "cpu"))
    path = str(tmp_path / "ref" / "model.pth")
    tck.save_torch_state_dict(path, tmodel, tparams)
    _assert_same(tck.load_torch_state_dict(path, tmodel, device="cpu"), params_np)
    _assert_same(params_from_numpy(
        jax.device_get(jck.load_torch_state_dict(path, jmodel)), "cpu"), params_np)
    with pytest.raises(ValueError, match="do not match"):
        tck.torch_state_dict_to_params(sd, mt.make_mlp_model(4, 8, 9, 16), device="cpu")
    with pytest.raises(ValueError, match="entries"):
        tck.params_to_torch_state_dict(tmodel, tparams[:3])
    assert os.path.exists(path)
    assert params_to_numpy(back)[1]["w"].shape == (4, 8)
