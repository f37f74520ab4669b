"""The port's ResNet-9 (``models/resnet9.py``) and its checkpoint shims
against the JAX package's flax model, on the same numpy variables and
images: eval logits and features on ``models/resnet9.msgpack``, the masked
variant, one training step (logits, loss, the updated parameters and the
running statistics) and the state-dict shims.  Tolerances are stated per
test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from montecarlopredictivecoding_tpu.models import resnet9 as jr
from montecarlopredictivecoding_tpu.utils import checkpoint as jckpt
from montecarlopredictivecoding_tpu_torch.models import resnet9 as tr
from montecarlopredictivecoding_tpu_torch.utils.precision import full_f32_conv
from montecarlopredictivecoding_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(1)

PATH = "models/resnet9.msgpack"


def flax_variables(path=PATH):
    with open(path, "rb") as f:
        raw = serialization.msgpack_restore(f.read())
    return raw["params"], raw["batch_stats"]


def port_state(params, stats, is_mask=False, tx=None):
    """The port's model and state from flax variables, through the port's
    shim."""
    model = tr.ResNet9(is_mask=is_mask)
    model.load_state_dict(tckpt.resnet9_to_torch_state_dict(params, stats, is_mask))
    return model, tr.state_from_module(model, tx)


def images(n, hw=(28, 28), seed=0):
    return np.random.default_rng(seed).random((n, 1) + hw, dtype=np.float32)


def rel_err(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


def test_eval_logits_and_features_on_the_shipped_weights():
    """8 images through ``models/resnet9.msgpack``: logits and the 256
    features within 2e-6 of the largest (f32 convolutions summed in another
    order)."""
    params, stats = flax_variables()
    x = images(8)
    jl, jf = jr.ResNet9().apply({"params": params, "batch_stats": stats},
                                jnp.asarray(x.transpose(0, 2, 3, 1)), train=False,
                                return_features=True)
    model, state = tr.load_resnet9(PATH, device="cpu")
    tl = tr.make_eval_fn(model)(state, torch.from_numpy(x))
    tf = tr.make_feature_fn(model)(state, torch.from_numpy(x))
    assert tuple(tf.shape) == (8, 256)
    assert rel_err(tl, jl) <= 2e-6 and rel_err(tf, jf) <= 2e-6


def test_masked_variant_from_random_parameters():
    """The 768-wide masked variant, flax's random initialisation sent across
    through the shim, on 14x28 bottom halves: logits and features (in
    flax's NHWC order, a real permutation of torch's at 1x3) within 2e-6 of
    the largest."""
    _, _, jstate = jr.init_resnet9(jax.random.PRNGKey(3), is_mask=True)
    # a non-trivial running state, so the eval-mode batch norm is tested
    stats = jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(np.random.default_rng(1).uniform(0.1, 0.5, a.shape),
                                  jnp.float32), jstate.batch_stats)
    x = images(6, (14, 28), seed=2)
    jl, jf = jr.ResNet9(is_mask=True).apply({"params": jstate.params, "batch_stats": stats},
                                            jnp.asarray(x.transpose(0, 2, 3, 1)), train=False,
                                            return_features=True)
    model, state = port_state(jstate.params, stats, is_mask=True)
    assert tuple(model.classifier.weight.shape) == (10, 768)
    tl = tr.make_eval_fn(model)(state, torch.from_numpy(x))
    tf = tr.make_feature_fn(model)(state, torch.from_numpy(x))
    assert tuple(tf.shape) == (6, 768)
    assert rel_err(tl, jl) <= 2e-6 and rel_err(tf, jf) <= 2e-6


def test_train_step_matches_flax():
    """One Adam step (lr 1e-3) from the shipped weights on 6 labelled
    images.  Training-mode logits within 2e-6 of the largest, the loss
    rtol 1e-5, the running means and variances (flax's biased variance,
    momentum 0.99) rtol 1e-5 (atol 1e-7).  Adam's first step is about
    -lr·sign(g), so the
    parameters are held to atol 1e-7 where the gradient is at least 1e-3 of
    its tensor's largest entry, and to 2·lr elsewhere.  A conv bias feeds a
    training-mode batch norm, which removes it: its gradient is rounding
    (under 1e-4 of the largest gradient) and its step the sign of that, so
    it is held to 2·lr only.  The input state is left as it was."""
    params, stats = flax_variables()
    x = images(6, seed=4)
    labels = np.array([0, 3, 5, 7, 9, 1])
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    model_j = jr.ResNet9()
    tx_j = optax.adam(1e-3)
    jstate = jr.ResNet9State(params, stats, tx_j.init(params))

    def loss_fn(p):
        logits, upd = model_j.apply({"params": p, "batch_stats": stats}, xj, train=True,
                                    mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean(), logits

    (jloss, jlogits), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    jnew, jloss2, jacc = jr.make_train_step(model_j, tx_j)(jstate, xj, jnp.asarray(labels))
    np.testing.assert_allclose(float(jloss2), float(jloss), rtol=1e-6)

    tx = tr.OptimizerSpec("adam", lr=1e-3).make()
    model, state = port_state(params, stats, tx=tx)
    before = {k: v.clone() for k, v in {**state.params, **state.batch_stats}.items()}
    model.train()
    with torch.no_grad(), full_f32_conv():
        tlogits = torch.func.functional_call(
            model, {**state.params, **{k: v.clone() for k, v in state.batch_stats.items()}},
            (torch.from_numpy(x),))
    assert rel_err(tlogits, jlogits) <= 2e-6
    new, loss, acc = tr.make_train_step(model, tx)(state, torch.from_numpy(x),
                                                   torch.from_numpy(labels))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert float(acc) == pytest.approx(float(jacc))
    for k, v in {**state.params, **state.batch_stats}.items():
        assert torch.equal(v, before[k]), k

    want = tckpt.resnet9_to_torch_state_dict(jnew.params, jnew.batch_stats)
    grads = tckpt.resnet9_to_torch_state_dict(jgrads, stats)
    for k, v in new.batch_stats.items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == 1
            continue
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-5, atol=1e-7, err_msg=k)
        assert not torch.equal(v, state.batch_stats[k]), k
    g_max = max(float(np.abs(np.asarray(g)).max()) for g in jax.tree_util.tree_leaves(jgrads))
    for k, v in new.params.items():
        g = grads[k].numpy()
        clear = np.abs(g) >= 1e-3 * np.abs(g).max()
        if k.endswith(".0.bias"):
            assert np.abs(g).max() <= 1e-4 * g_max, k
            clear[:] = False
        np.testing.assert_allclose(v.numpy()[clear], want[k].numpy()[clear], rtol=0,
                                   atol=1e-7, err_msg=k)
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0, atol=2e-3 + 1e-6,
                                   err_msg=k)


def test_batch_norm_is_flaxs_not_torchs():
    """The running variance moves toward the biased batch variance at
    momentum 0.99, as flax's does (``nn.BatchNorm2d`` would take the
    unbiased one); rtol 1e-6."""
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(3, 4, 5, 5)).astype(np.float32))
    bn = tr.BatchNorm(4).train()
    bn(x)
    var = x.double().var(dim=(0, 2, 3), unbiased=False)
    np.testing.assert_allclose(bn.running_var.numpy(), (0.99 + 0.01 * var).numpy(), rtol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               (0.01 * x.double().mean(dim=(0, 2, 3))).numpy(), rtol=1e-5,
                               atol=1e-9)


def test_mish_matches_jax_above_softplus_threshold():
    """Mish where ``F.softplus`` switches to x (above 20) and below: within
    1 f32 ulp of the JAX package's (rtol 1.2e-7, atol 1e-30)."""
    x = np.array([-30.0, -5.0, -0.3, 0.0, 0.7, 5.0, 19.9, 20.0, 20.1, 40.0, 90.0], np.float32)
    np.testing.assert_allclose(tr.mish(torch.from_numpy(x)).numpy(),
                               np.asarray(jr.mish(jnp.asarray(x))), rtol=1.2e-7, atol=1e-30)


def test_full_f32_conv_scopes_tf32():
    """The flags are off inside and restored after, TF32's default
    included."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        with full_f32_conv():
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.parametrize("is_mask", [False, True])
def test_state_dict_shims_match_jax(is_mask):
    """Flax variables -> torch state dict and back, equal to the JAX
    package's shims bit for bit, ``num_batches_tracked`` included; the
    port's module loads the result strictly."""
    _, _, jstate = jr.init_resnet9(jax.random.PRNGKey(5), is_mask=is_mask)
    sd = tckpt.resnet9_to_torch_state_dict(jstate.params, jstate.batch_stats, is_mask)
    jsd = jckpt.resnet9_to_torch_state_dict(jstate.params, jstate.batch_stats, is_mask)
    assert set(sd) == set(jsd)
    for k in sd:
        assert torch.equal(sd[k], jsd[k]), k
    tr.ResNet9(is_mask=is_mask).load_state_dict(sd, strict=True)
    params, stats = tckpt.resnet9_from_torch_state_dict(sd, is_mask)
    jparams, jstats = jckpt.resnet9_from_torch_state_dict(jsd, is_mask)
    for a, b in ((params, jparams), (stats, jstats)):
        la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
        assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(
            jax.tree_util.tree_map(np.asarray, b))
        for x, y in zip(la, lb):
            np.testing.assert_array_equal(x, np.asarray(y))


def test_flax_file_round_trip(tmp_path):
    """The port reads ``models/resnet9.msgpack`` as flax does, and what
    ``save_resnet9`` writes flax's ``from_bytes`` reads back equal."""
    params, stats = flax_variables()
    raw = tckpt.read_checkpoint(PATH)
    for a, b in zip(jax.tree_util.tree_leaves(raw), jax.tree_util.tree_leaves((
            {"batch_stats": stats, "params": params}))):
        np.testing.assert_array_equal(a, np.asarray(b))
    sd = tckpt.load_resnet9_state_dict(PATH)
    out = tmp_path / "r9.msgpack"
    tckpt.save_resnet9(str(out), sd)
    _, _, target = jr.init_resnet9(jax.random.PRNGKey(0))
    back = serialization.from_bytes({"params": target.params, "batch_stats": target.batch_stats},
                                    out.read_bytes())
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves({"params": params, "batch_stats": stats})):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_init_resnet9_shapes_match_flax():
    """The port's initial parameters have flax's shapes (through the shim)
    and flax's initialisation: zero biases, kernels of variance about
    1/fan_in."""
    for is_mask in (False, True):
        model, tx, state = tr.init_resnet9(torch.Generator().manual_seed(0), is_mask=is_mask,
                                           device="cpu")
        _, _, jstate = jr.init_resnet9(jax.random.PRNGKey(0), is_mask=is_mask)
        params, stats = tckpt.resnet9_from_torch_state_dict(
            {**state.params, **state.batch_stats}, is_mask)
        assert jax.tree_util.tree_map(np.shape, params) == jax.tree_util.tree_map(
            np.shape, jax.tree_util.tree_map(np.asarray, jstate.params))
        w = state.params["conv2.0.weight"]
        assert float(w.std()) == pytest.approx((1.0 / (64 * 9)) ** 0.5, rel=0.05)
        assert float(state.params["conv2.0.bias"].abs().max()) == 0.0
        assert state.opt_state is not None
