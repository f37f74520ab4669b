"""Latent draws from a CPU generator for a CUDA device.

``core/modules.random_tensor`` draws such a tensor in pinned host memory and
copies it on the current stream without a host wait.  The tests hold it to
the same draws moved with a blocking ``.to`` (the benchmark's
``replay_latents`` recipe, and the path every other case keeps), check that
no call waits for the card and that a pinned block is not drawn into again
before its copy has run, and that the CPU and generator-less paths are
unchanged.

This file imports neither JAX nor the JAX package, so its card tests run on
a GPU machine without JAX (``tests/conftest.py`` imports JAX, hence
``--noconftest``):

    python -m pytest tests/test_torch_latent_draws.py -q -m cuda --noconftest

Without a CUDA device the tests marked ``cuda`` skip.
"""

import pytest
import torch

from montecarlopredictivecoding_tpu_torch.core.model import make_mlp_model
from montecarlopredictivecoding_tpu_torch.core.modules import (
    normal_init,
    random_tensor,
    uniform_init,
)
from montecarlopredictivecoding_tpu_torch.experiments import train_mnist

FID = (20, 128, 128, 784)
MSE = (10, 256, 256, 784)
KINDS = {"uniform": uniform_init, "normal": normal_init}
BATCHES = (1, 37, 256, 1024)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (the staged copy is CUDA only)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model_inputs(kind, dims, B, device, seed=5):
    model = make_mlp_model(*dims, sample_x_fn=KINDS[kind])
    params = model.init(torch.Generator().manual_seed(seed), device=device)
    return model, params, torch.zeros(B, dims[0], device=device)


def _blocking_draws(kind, gen, B, dims, device):
    """Each site's latents as the parent drew them: the CPU generator's draws
    in site order, moved with a blocking ``.to``, then the site's own
    arithmetic on ``device``."""
    out = []
    for d in dims[:3]:
        if kind == "uniform":
            out.append(-10.0 + 20.0 * torch.rand((B, d), generator=gen).to(device))
        else:
            out.append(torch.randn((B, d), generator=gen).to(device))
    return out


def _assert_equal_sites(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device == w.device and g.dtype == w.dtype
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# The paths that stay as they were (run everywhere).
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_cpu_target_takes_the_plain_draw(kind):
    before = random_tensor.staged
    got = random_tensor(kind, (7, 11), torch.Generator().manual_seed(3), torch.float32, "cpu")
    fn = torch.rand if kind == "uniform" else torch.randn
    want = fn((7, 11), generator=torch.Generator().manual_seed(3))
    assert torch.equal(got, want) and not got.is_pinned()
    assert random_tensor.staged == before


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_no_generator_takes_the_plain_draw(kind):
    before = random_tensor.staged
    torch.manual_seed(8)
    got = random_tensor(kind, (5, 9), None, torch.float32, torch.device("cpu"))
    torch.manual_seed(8)
    fn = torch.rand if kind == "uniform" else torch.randn
    assert torch.equal(got, fn((5, 9)))
    assert random_tensor.staged == before


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("dims", [FID, MSE], ids=["fid", "mse"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_cpu_init_latents_is_the_replay(kind, dims, B):
    model, params, pseudo = _model_inputs(kind, dims, B, "cpu")
    before = random_tensor.staged
    got = model.init_latents(params, pseudo, torch.Generator().manual_seed(11))
    want = _blocking_draws(kind, torch.Generator().manual_seed(11), B, dims, "cpu")
    _assert_equal_sites(got, want)
    assert random_tensor.staged == before


# ---------------------------------------------------------------------------
# The staged path (the card).
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("dims", [FID, MSE], ids=["fid", "mse"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_init_latents_is_the_blocking_replay(cuda_device, kind, dims, B):
    model, params, pseudo = _model_inputs(kind, dims, B, cuda_device)
    gen = torch.Generator().manual_seed(11)
    before = random_tensor.staged
    got = model.init_latents(params, pseudo, gen)
    assert random_tensor.staged == before + 3  # one a PC site
    want = _blocking_draws(kind, torch.Generator().manual_seed(11), B, dims, cuda_device)
    _assert_equal_sites(got, want)
    # the generator stands where the three plain draws leave it
    ref = torch.Generator().manual_seed(11)
    for d in dims[:3]:
        (torch.rand if kind == "uniform" else torch.randn)((B, d), generator=ref)
    assert torch.equal(gen.get_state(), ref.get_state())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1,), (37, 20), (256, 128), (1024, 256), (3, 5, 7)])
def test_random_tensor_normal_is_the_blocking_draw(cuda_device, shape):
    before = random_tensor.staged
    got = random_tensor("normal", shape, torch.Generator().manual_seed(4), torch.float32,
                        cuda_device)
    assert random_tensor.staged == before + 1
    want = torch.randn(shape, generator=torch.Generator().manual_seed(4)).to(cuda_device)
    assert got.is_cuda and torch.equal(got, want)


@pytest.mark.cuda
def test_card_generator_and_no_generator_keep_their_path(cuda_device):
    before = random_tensor.staged
    got = random_tensor("uniform", (64, 20), torch.Generator(cuda_device).manual_seed(2),
                        torch.float32, cuda_device)
    want = torch.rand((64, 20), generator=torch.Generator(cuda_device).manual_seed(2),
                      device=cuda_device)
    assert torch.equal(got, want)
    torch.manual_seed(6)
    got = random_tensor("normal", (64, 20), None, torch.float32, cuda_device)
    torch.manual_seed(6)
    assert torch.equal(got, torch.randn((64, 20), device=cuda_device))
    assert random_tensor.staged == before


def _training_state(device, seed=0):
    model, params, pseudo = _model_inputs("uniform", FID, 256, device, seed)
    config = train_mnist.mcpc_training_config()
    data = (torch.rand(256, FID[3], generator=torch.Generator().manual_seed(seed)) > 0.5)
    return model, params, pseudo, config, data.float().to(device)


def _leaves(params, opt_state):
    adam = opt_state[0]
    out = []
    for tree in (params, adam.mu, adam.nu):
        out += [p[k] for p in tree for k in sorted(p)]
    return adam.count, out


@pytest.mark.cuda
def test_one_batch_is_the_same_on_staged_and_blocking_latents(cuda_device):
    model, params, pseudo, config, data = _training_state(cuda_device)
    results = []
    for staged in (True, False):
        gen = torch.Generator().manual_seed(21)
        if staged:
            latents = model.init_latents(params, pseudo, gen)
        else:
            latents = tuple(_blocking_draws("uniform", gen, 256, FID, cuda_device))
        seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen))
        state = train_mnist.param_optimizer(config).init(params)
        p, s = params, state
        for _ in range(2):
            p, s = train_mnist.one_batch(p, s, latents, seed, data, config=config)
        results.append(_leaves(p, s))
    (count_a, a), (count_b, b) = results
    assert count_a == count_b == 2
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.cuda
def test_init_latents_never_waits_for_the_card(cuda_device):
    model, params, pseudo = _model_inputs("uniform", FID, 256, cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        model.init_latents(params, pseudo, torch.Generator().manual_seed(1))
        model.init_latents(params, pseudo, torch.Generator().manual_seed(2))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [FID, MSE], ids=["fid", "mse"])
def test_pinned_blocks_wait_for_their_copies(cuda_device, dims):
    """With the stream held busy every copy is still queued when the next
    draw takes a pinned block, so a block handed out again too early would
    put a later draw into an earlier batch's latents."""
    B, calls = 256, 8
    model, params, pseudo = _model_inputs("uniform", dims, B, cuda_device)
    gen = torch.Generator().manual_seed(31)
    torch.cuda.synchronize()
    before = random_tensor.staged
    torch.cuda._sleep(2_000_000_000)  # about a second of the card's clock
    got = [model.init_latents(params, pseudo, gen) for _ in range(calls)]
    # the host did not wait: the stream is still on the sleep
    assert not torch.cuda.current_stream().query()
    assert random_tensor.staged == before + 3 * calls
    torch.cuda.synchronize()
    ref = torch.Generator().manual_seed(31)
    for latents in got:
        _assert_equal_sites(latents, _blocking_draws("uniform", ref, B, dims, cuda_device))
