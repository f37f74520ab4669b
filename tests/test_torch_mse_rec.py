"""``eval/metrics.get_mse_rec`` reads the batches' squared-error sums back to
the host once a call, after the last batch, and returns what a ``float()``
a batch returns, bit for bit: each sum is the same float32 number widened
to a double, added in batch order in float64.  On the card, the one
read-back is the call's only blocking runtime call.

This file imports neither JAX nor the JAX package, so its card test runs on
a GPU machine without JAX (``tests/conftest.py`` imports JAX, hence
``--noconftest``):

    python -m pytest tests/test_torch_mse_rec.py -q -m cuda --noconftest

Without a CUDA device the test marked ``cuda`` skips.
"""

import json

import pytest
import torch

import montecarlopredictivecoding_tpu_torch as mt
from montecarlopredictivecoding_tpu_torch.eval import metrics
from montecarlopredictivecoding_tpu_torch.models.factory import get_pc_trainer
from montecarlopredictivecoding_tpu_torch.utils import observability as obs

torch.set_num_threads(1)

DIMS = (6, 10, 12, 22)  # 11 hidden columns: a row's mean is not a short binary fraction
MSE = (10, 256, 256, 784)
# the CUDA runtime calls that block the host until the card has done the
# work before them (a synchronous cudaMemcpy included)
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")


def mse_config(dims, activation, T_pc, lr):
    return {"input_size": dims[0], "hidden_size": dims[1], "hidden2_size": dims[2],
            "output_size": dims[3], "loss_fn": mt.bernoulli_fn, "activation_fn": activation,
            "input_var": None, "T_pc": T_pc, "optimizer_x_fn_pc": "adam",
            "optimizer_x_kwargs_pc": {"lr": lr}}


def make_batches(k, B, D, device, seed=30):
    g = torch.Generator().manual_seed(seed)
    return [((torch.rand((B, D), generator=g) > 0.5).float().to(device), None)
            for _ in range(k)]


def new_gen(dims, activation, device, seed=9):
    return mt.GenerativeModel(mt.make_mlp_model(*dims, activation=activation), seed,
                              device=device)


def per_batch_mse(gen, config, batches):
    """The masked-reconstruction MSE with a ``float()`` read-back a batch."""
    trainer = get_pc_trainer(gen, config, is_mcpc=True, training=False)
    mse, n_data = 0.0, 0
    for data, _ in batches:
        trainer.train_on_batch(
            torch.zeros((data.shape[0], config["input_size"]), device=data.device),
            loss_fn=mt.bernoulli_fn_mask,
            loss_fn_kwargs={"_target": data, "_var": config["input_var"]},
            is_return_results_every_t=False,
        )
        img = (metrics.decode_from_deepest_latent(gen) > 0).to(data.dtype)
        k = round(data.shape[1] / 2)
        mse += float(torch.sum(torch.mean((img[:, :-k] - data[:, :-k]) ** 2, dim=1)))
        n_data += data.shape[0]
    return mse / n_data


@pytest.mark.parametrize("activation", ["relu", "tanh"])
@pytest.mark.parametrize("k", [1, 3])
def test_get_mse_rec_is_the_per_batch_read_back(k, activation):
    """k batches of 37, 6 Adam steps at lr 0.3: the same model, generator
    seed and batches give the per-batch loop's MSE exactly, and the same
    latents after the call."""
    config = mse_config(DIMS, activation, 6, 0.3)
    batches = make_batches(k, 37, DIMS[3], "cpu")
    gen = new_gen(DIMS, activation, "cpu")
    mse = metrics.get_mse_rec(gen, config, batches)
    want_gen = new_gen(DIMS, activation, "cpu")
    want = per_batch_mse(want_gen, config, batches)
    assert mse == want and 0.0 < mse < 1.0
    for a, b in zip(gen.latents, want_gen.latents):
        assert torch.equal(a, b)


def test_get_mse_rec_on_no_batches_raises():
    """An empty batch list divides by no images, as it always has."""
    gen = new_gen(DIMS, "relu", "cpu")
    with pytest.raises(ZeroDivisionError):
        metrics.get_mse_rec(gen, mse_config(DIMS, "relu", 6, 0.3), [])


@pytest.mark.cuda
def test_get_mse_rec_waits_for_the_card_once_a_call(tmp_path):
    """Table 1's reconstruction model, 3 batches of 1024 with 250 Adam steps
    on the card: one blocking runtime call inside the call (after a warm-up
    call that builds the kernels), and the per-batch loop's MSE bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (the read-back waits for the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    config = mse_config(MSE, "relu", 250, 0.7)
    batches = make_batches(3, 1024, MSE[3], device)
    metrics.get_mse_rec(new_gen(MSE, "relu", device), config, batches)  # builds the kernels
    torch.cuda.synchronize()

    gen = new_gen(MSE, "relu", device)
    with obs.profile_trace(str(tmp_path)) as prof:
        with torch.profiler.record_function("test.get_mse_rec"):
            mse = metrics.get_mse_rec(gen, config, batches)
    with open(prof.trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    (call,) = [e for e in events
               if e.get("cat") == "user_annotation" and e["name"] == "test.get_mse_rec"]
    runtime = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
               and call["ts"] <= e["ts"] <= call["ts"] + call["dur"]]
    waits = [e["name"] for e in runtime if e["name"] in WAITS]
    assert sum(e["name"] == "cudaLaunchKernel" for e in runtime) > 0  # the profiler saw the card
    assert len(waits) == 1, waits

    assert mse == per_batch_mse(new_gen(MSE, "relu", device), config, batches)
