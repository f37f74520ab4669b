"""``train_mnist``'s command line with ``--mesh 2`` on the CPU.

Two spawned ranks get torchrun's environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``) and call ``train_mnist.main([...,
"--mesh", "2", "--device", "cpu"])`` in the tiny setting of
``torch_dp_ranks`` (``tests/test_train_mesh.py``'s configuration, 2
batches of 64), which makes a gloo group from that environment.  Then the
same ranks meet again and run ``train_mcpc(mesh=2)`` on the same data and
seed (``torch_dp_ranks.mesh_cli_rank``).  Held: rank 0 alone prints and
writes the checkpoint, and that checkpoint is bit for bit what
``train_mcpc(mesh=2)`` gives.  A run whose port another process took
first goes again once, on a new port.
"""

import os

import pytest
import torch

import torch_dp_ranks
from montecarlopredictivecoding_tpu_torch.utils import load_checkpoint

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cli_ranks(tmp_path_factory):
    """The two ranks' results.  The port is free when chosen, but another
    process may bind it before rank 0 does; then the run goes again once,
    on a new port."""
    for attempt in range(2):
        tmp = str(tmp_path_factory.mktemp("mesh_cli"))
        try:
            ranks = torch_dp_ranks.run_ranks(torch_dp_ranks.mesh_cli_rank, 2, tmp,
                                             master_port=torch_dp_ranks.free_port())
        except RuntimeError as err:
            if attempt or not torch_dp_ranks.port_taken(err):
                raise
            continue
        return tmp, ranks


def test_only_rank_0_prints(cli_ranks):
    _, (rank0, rank1) = cli_ranks
    assert rank0["stdout"].startswith("epoch 1: ")
    assert rank1["stdout"] == ""


def test_only_rank_0_writes_the_checkpoint(cli_ranks):
    tmp, (rank0, rank1) = cli_ranks
    assert rank0["cli_wrote"] and not rank1["cli_wrote"]
    assert rank0["reference_wrote"] and not rank1["reference_wrote"]
    assert not rank0["group_after_cli"] and not rank1["group_after_cli"]


def test_checkpoint_is_what_train_mcpc_mesh_gives(cli_ranks):
    tmp, (rank0, rank1) = cli_ranks
    with open(os.path.join(tmp, "cli_rank0.msgpack"), "rb") as f:
        cli_bytes = f.read()
    with open(os.path.join(tmp, "reference_rank0.msgpack"), "rb") as f:
        assert f.read() == cli_bytes
    reference = rank0["reference_params"]
    restored = load_checkpoint(os.path.join(tmp, "cli_rank0.msgpack"), reference, device="cpu")
    for got, want, other in zip(restored, reference, rank1["reference_params"]):
        for k in want:
            assert torch.equal(got[k], want[k]) and torch.equal(other[k], want[k])
