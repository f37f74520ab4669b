"""The readers of the program's ``mcpc.*`` spans: on a hand-built timeline
whose self-idle times, wait counts and unspanned share are worked by hand,
on a timeline without the program's spans (an older commit: nothing to
read), and in a tiny traced CPU run of each cell kind."""

import dataclasses
import json
import types

import pytest
import torch

from port_bench import run as bench
from port_bench.lib import cell as cells
from port_bench.lib import program_spans
from port_bench.lib.cell import BENCH_DIR
from port_bench.lib.trace import WINDOW, Kernel, Timeline
from port_bench.tests import tiny

ROOT = BENCH_DIR.parent
CPU = torch.device("cpu")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW = ["init_latents_idle_ms.train", "init_latents_idle_ms.eval", "chain_wrapper_idle_us.train",
       "trainer_self_idle_ms.sample", "trainer_self_idle_ms.eval", "capture_rows_ms.sample",
       "mse_score_idle_ms.eval", "host_waits.train", "host_waits.eval",
       "unspanned_idle_share.train", "unspanned_idle_share.eval"]
CELL_OF = {"train": "mcpc_fid.train", "sample": "mcpc_fid.sample", "eval": "mcpc_mse.eval"}

# µs; the device is busy in [10, 20), [40, 60), [90, 95): idle 65 of the 100
BUSY = [(10.0, 20.0), (40.0, 60.0), (90.0, 95.0)]


def timeline(spans, host=(), kernels=()):
    return Timeline(0.0, 100.0, list(kernels), BUSY, [(WINDOW, 0.0, 100.0)] + list(spans),
                    list(host))


def read(name, tl, kind):
    ctx = types.SimpleNamespace(timeline=tl, window=None, cell=None, kind=kind)
    return cells.metric_reader(name).read(ctx)


TRAIN_SPANS = [("mcpc.init_latents", 0.0, 25.0), ("mcpc.one_batch", 30.0, 40.0),
               ("mcpc.chain", 32.0, 30.0), ("mcpc.capture_rows", 50.0, 8.0)]
TRAIN_HOST = [("cudaStreamSynchronize", 5.0, 1.0),   # in mcpc.init_latents: counts
              ("cudaStreamSynchronize", 27.0, 1.0),  # between spans: does not
              ("cudaMemcpyAsync", 33.0, 1.0),        # does not block
              ("cudaMemcpy", 55.0, 1.0),             # in mcpc.capture_rows: counts
              ("cudaDeviceSynchronize", 69.0, 0.5),  # in mcpc.one_batch: counts
              ("cudaEventSynchronize", 80.0, 1.0),   # after the spans: does not
              ("aten::item", 6.0, 1.0)]


def test_train_readers_by_hand():
    tl = timeline(TRAIN_SPANS, TRAIN_HOST)
    # init_latents [0, 25): idle [0, 10) and [20, 25)
    assert read("init_latents_idle_ms.train", tl, "train") == pytest.approx(15e-3)
    # chain [32, 62) less capture rows [50, 58): idle [32, 40) and [60, 62)
    assert read("chain_wrapper_idle_us.train", tl, "train") == pytest.approx(10.0)
    assert read("host_waits.train", tl, "train") == 3.0
    # idle outside [0, 25) and [30, 70): [25, 30), [70, 90), [95, 100)
    assert read("unspanned_idle_share.train", tl, "train") == pytest.approx(100.0 * 30 / 65)


def test_eval_readers_by_hand():
    spans = [("mcpc.train_on_batch", 0.0, 60.0), ("mcpc.init_latents", 0.0, 25.0),
             ("mcpc.chain", 30.0, 25.0), ("mcpc.mse_rec.score", 60.0, 2.0),
             ("mcpc.train_on_batch", 62.0, 38.0), ("mcpc.mse_rec.score", 99.0, 1.0)]
    host = [("cudaStreamSynchronize", t, 0.5) for t in (1.0, 12.0, 21.0, 61.0, 70.0, 99.5)]
    tl = timeline(spans, host)
    # self [25, 30) and [55, 60): idle 5; the second call has no children:
    # idle [62, 90) and [95, 100), 33
    assert read("trainer_self_idle_ms.eval", tl, "eval") == pytest.approx((5 + 33) / 2 / 1e3)
    assert read("init_latents_idle_ms.eval", tl, "eval") == pytest.approx(15e-3)
    assert read("mse_score_idle_ms.eval", tl, "eval") == pytest.approx((2 + 1) / 2 / 1e3)
    assert read("host_waits.eval", tl, "eval") == 3.0
    assert read("unspanned_idle_share.eval", tl, "eval") == 0.0


def test_sample_readers_by_hand():
    spans = [("mcpc.train_on_batch", 0.0, 70.0), ("mcpc.chain", 30.0, 40.0),
             ("mcpc.capture_rows", 50.0, 8.0)]
    kernels = [Kernel("mcpc_chain_kernel", 40.0, 9.0, 33.0),
               Kernel("gemm", 52.0, 3.0, 51.0), Kernel("reduce", 56.0, 2.0, 55.0),
               Kernel("gemm", 90.0, 5.0, 80.0), Kernel("copy", 91.0, 1.0, None)]
    tl = timeline(spans, kernels=kernels)
    assert read("capture_rows_ms.sample", tl, "sample") == pytest.approx(5e-3)
    # self [0, 30): idle [0, 10) and [20, 30)
    assert read("trainer_self_idle_ms.sample", tl, "sample") == pytest.approx(20e-3)
    assert program_spans.launches_inside(tl, "mcpc_chain_kernel", "mcpc.chain") == 100.0
    assert program_spans.launches_inside(tl, "gemm", "mcpc.capture_rows") == 50.0
    assert program_spans.launches_inside(tl, "nothing", "mcpc.chain") is None


def test_spans_are_clipped_to_the_window():
    tl = timeline([("mcpc.init_latents", -50.0, 60.0)])
    assert read("init_latents_idle_ms.train", tl, "train") == pytest.approx(10e-3)


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_without_the_programs_spans(name):
    """An older program has no ``mcpc.*`` span: each reader returns None
    (and so does each in a cell of another kind)."""
    tl = timeline([("bench.one_batch", 30.0, 40.0), ("bench.train_on_batch", 0.0, 60.0)],
                  TRAIN_HOST)
    kind = name.rsplit(".", 1)[1]
    assert read(name, tl, kind) is None
    other = {"train": "eval", "eval": "sample", "sample": "train"}[kind]
    assert read(name, timeline(TRAIN_SPANS, TRAIN_HOST), other) is None


def test_minus_and_inside():
    assert program_spans.minus([(0, 10), (20, 30)], [(2, 3), (5, 22), (25, 26), (29, 40)]) == \
        [(0, 2), (3, 5), (22, 25), (26, 29)]
    assert program_spans.minus([(0, 10)], []) == [(0, 10)]
    assert program_spans.minus([(0, 10)], [(-5, 12)]) == []
    assert program_spans.inside([(0, 1), (2, 3)], 2.5)
    assert not program_spans.inside([(0, 1), (2, 3)], 1.5)
    assert not program_spans.inside([(0, 1)], 1)


def test_entries_name_their_readers():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for name in NEW:
        m = entries[name]
        assert m["workloads"] == [CELL_OF[name.rsplit(".", 1)[1]]], name
        assert cells.metric_reader(name) is not None
    assert [m["name"] for m in BENCH["per_layer"]][-len(NEW):] == NEW


@pytest.mark.parametrize("kind", ["train", "sample", "eval"])
def test_tiny_traced_run_reports_its_cells_metrics(kind):
    """A traced tiny run on the CPU (no device: every span is idle) reports
    each new metric its cell lists, and no other."""
    torch.set_num_threads(1)
    entries = [m for m in BENCH["per_layer"] if m["name"] in NEW]
    c = dataclasses.replace(tiny.cell(kind), per_layer=entries)
    res = bench.run(c, tiny.SEED, 0.3, True, CPU)
    assert res["correct"], res["limits"]
    expect = {m["name"] for m in entries if CELL_OF[kind] in m["workloads"]}
    assert set(res["metrics"]) == expect
    for name, m in res["metrics"].items():
        assert m["value"] >= 0, name
        if name.startswith("host_waits"):
            assert m["value"] == 0.0  # no CUDA runtime on the CPU
        if name.startswith("unspanned_idle_share"):
            assert m["value"] < 100.0
