"""The FID cell (``entries/fid.py``) at a tiny size on the CPU: the
published InceptionV3 graph, a handful of samples in batches of 4 and a
reference split of 4 + 4 images (the cell's 10,000 would take minutes
here).  A run reads ``correct``; each fault the comparison must catch,
planted in the port's graph or on the path that builds the test
statistics, and the control with TF32 emulated read ``correct`` false; a program without the extractor's batch counter stops in
set-up; the readers return None without the program's spans and read a
timeline that has them; the convolution count."""

import json
import types

import pytest
import torch
import torch.nn.functional as F

from port_bench import run as bench
from port_bench.lib import fid_readers
from port_bench.lib.cell import BENCH_DIR, Cell, entry_module, metric_reader
from port_bench.lib.trace import Kernel, Timeline
from port_bench.reference import inception_flops
from port_bench.tests import tiny

from montecarlopredictivecoding_tpu_torch.data import mnist
from montecarlopredictivecoding_tpu_torch.eval import fid
from montecarlopredictivecoding_tpu_torch.eval import inception as inc

CPU = torch.device("cpu")
READERS = ["mfu.fid", "features_roofline.fid", "features_other_ms.fid", "fid_stats_ms.fid",
           "idle_share.fid", "host_waits.fid", "unspanned_idle_share.fid"]


def setup_module():
    torch.set_num_threads(1)


@pytest.fixture
def small_split(monkeypatch):
    """The synthetic test split cut to 4 validation and 4 test images."""
    small = mnist._synthetic_mnist(4, 8)
    monkeypatch.setattr(mnist, "load_mnist_arrays",
                        lambda root="MNIST_data", allow_synthetic=True: small)
    monkeypatch.setattr(fid, "VAL_IMAGES", 4)
    monkeypatch.setattr(fid, "TEST_IMAGES", 4)


def tiny_cell() -> Cell:
    mix = json.loads((BENCH_DIR / "mixes" / "fid.json").read_text())
    mix.update(n_samples=6, feature_batch=4, val_images=4, test_images=4)
    model = json.loads((BENCH_DIR / "configs" / "inception_fid.json").read_text())
    metrics = [{"name": "eval_images_per_s", "unit": "images/s"}, {"name": "setup_s", "unit": "s"}]
    return Cell("tiny.fid", model, mix, metrics, [], 1)


def test_tiny_fid_cell_is_correct(small_split):
    res = bench.run(tiny_cell(), tiny.SEED, 0.1, False, CPU)
    w = res.pop("_window")
    assert w.items >= 1 and res["attempted"] == w.items and res["failed"] == 0
    assert res["correct"], res["limits"]
    assert set(res["limits"]) == {"image_gap", "feature_gap", "fid_gap"}
    assert set(res["metrics"]) == {"eval_images_per_s", "setup_s"}
    assert w.feature_batches == w.items * [4, 2]


FAULTS = {
    "avg_pools_count_padding": ("avg_pool_excl", lambda orig: (
        lambda x, k=3, stride=1, padding=1: F.avg_pool2d(x, k, stride, padding,
                                                         count_include_pad=True))),
    "mixed_7c_average_pool": ("inception_e", lambda orig: (
        lambda x, p, pool: orig(x, p, "avg"))),
    "resize_align_corners": ("resize_bilinear", lambda orig: (
        lambda x, size: F.interpolate(x, size=(size, size), mode="bilinear",
                                      align_corners=True))),
    "batch_norm_skipped": ("batch_norm", lambda orig: (lambda x, p: x)),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_fault_reads_incorrect(small_split, monkeypatch, fault):
    attr, make = FAULTS[fault]
    monkeypatch.setattr(inc, attr, make(getattr(inc, attr)))
    res = bench.run(tiny_cell(), tiny.SEED, 0.1, False, CPU)
    assert not res["correct"]
    assert res["limits"]["feature_gap"]["value"] > res["limits"]["feature_gap"]["limit"]


STATS_FAULTS = {
    # the program's split of the test set one image off the mix's
    "split_shifted": lambda monkeypatch: monkeypatch.setattr(fid, "VAL_IMAGES", 3),
    # the cached covariance written a part in a thousand off
    "saved_sigma_scaled": lambda monkeypatch: monkeypatch.setattr(
        fid.FIDStats, "save", (lambda save: lambda self, path, source="": save(
            fid.FIDStats(self.mu, self.sigma * 1.001), path, source))(fid.FIDStats.save)),
}


@pytest.mark.parametrize("fault", list(STATS_FAULTS))
def test_test_statistics_fault_reads_incorrect(small_split, monkeypatch, fault):
    """A fault in the statistics that set-up caches moves the program's FID
    and not the reference's, which takes the test images afresh."""
    STATS_FAULTS[fault](monkeypatch)
    res = bench.run(tiny_cell(), tiny.SEED, 0.1, False, CPU)
    assert not res["correct"]
    assert res["limits"]["fid_gap"]["value"] > res["limits"]["fid_gap"]["limit"]


def test_control_with_tf32_emulated_reads_incorrect(small_split):
    cell = tiny_cell()

    def conv(x, w, b, stride, padding):
        return F.conv2d(tiny.tf32(x), tiny.tf32(w), b, stride, padding)

    numbers = entry_module(cell).control(cell, tiny.SEED, CPU, mm=tiny.tf32_matmul, conv_fn=conv)
    assert not all(n.ok for n in numbers)
    assert not {n.name: n for n in numbers}["feature_gap"].ok


def test_a_program_without_the_batch_counter_stops_in_setup(small_split, monkeypatch):
    """As the parent commit does: before any image goes through the
    network."""
    make = inc.make_inception_features

    def without_counter(**kw):
        fn = make(**kw)
        del fn.batches
        return fn

    monkeypatch.setattr(inc, "make_inception_features", without_counter)
    calls = []
    monkeypatch.setattr(inc, "inception_pool3_features", lambda *a: calls.append(a))
    with pytest.raises(AttributeError):
        entry_module(tiny_cell()).setup(tiny_cell(), tiny.SEED, CPU, None)
    assert calls == []


def _ctx(spans, host, kernels, feature_batches=(64, 8)):
    tl = Timeline(0.0, 1e6, kernels, [(k.ts, k.ts + k.dur) for k in kernels],
                  [(n, s, d) for n, s, d in spans], list(host) + list(spans))
    window = types.SimpleNamespace(flops=2 * 72 * inception_flops.image_flops(),
                                   feature_batches=list(feature_batches))
    return types.SimpleNamespace(timeline=tl, window=window, cell=None, kind="fid")


def test_readers_return_none_without_the_spans():
    k = [Kernel("sm90_xmma_fprop", 10.0, 100.0, 5.0)]
    ctx = _ctx([("bench.get_fid", 0.0, 1e5)], [("aten::conv2d", 4.0, 2.0)], k)
    for name in READERS:
        assert metric_reader(name).read(ctx) is None, name
    other = types.SimpleNamespace(**dict(vars(_ctx([("mcpc.fid.features", 0.0, 1e5)], [], k)),
                                         kind="eval"))
    for name in READERS:
        assert metric_reader(name).read(other) is None, name


def test_readers_on_a_timeline_with_the_spans():
    """Two calls' spans; kernels launched inside a convolution operator or
    outside one, inside the features span or after it."""
    spans = [("mcpc.fid.features", 0.0, 1000.0), ("mcpc.fid.stats", 1000.0, 300.0),
             ("mcpc.fid.distance", 1300.0, 700.0),
             ("mcpc.fid.features", 5000.0, 1000.0), ("mcpc.fid.stats", 6000.0, 100.0),
             ("mcpc.fid.distance", 6100.0, 900.0)]
    host = [("aten::conv2d", 10.0, 50.0), ("aten::conv2d", 5010.0, 50.0),
            ("cudaStreamSynchronize", 900.0, 10.0), ("cudaStreamSynchronize", 2500.0, 10.0)]
    kernels = [Kernel("conv_a", 20.0, 400.0, 20.0), Kernel("bn_relu", 420.0, 100.0, 70.0),
               Kernel("conv_b", 5020.0, 600.0, 5020.0), Kernel("cat", 5620.0, 300.0, 5500.0),
               Kernel("eigh", 6100.0, 500.0, 6050.0)]
    ctx = _ctx(spans, host, kernels)
    assert fid_readers.features_other_ms(ctx) == pytest.approx(0.2)  # (100 + 300) µs / 2 calls
    assert fid_readers.stats_ms(ctx) == pytest.approx(1.0)  # (300 + 700 + 100 + 900) µs / 2
    bound = inception_flops.forward_bound_s(64)[0] + inception_flops.forward_bound_s(8)[0]
    assert fid_readers.features_roofline(ctx) == pytest.approx(100 * bound / 1400e-6)
    assert fid_readers.host_waits(ctx) == pytest.approx(0.5)  # the one wait inside a span
    assert fid_readers.idle_share(ctx) == pytest.approx(100 * (1 - 1900 / 1e6))
    assert fid_readers.mfu(ctx) == pytest.approx(100 * 144 * inception_flops.image_flops() / 165e12)
    # idle in the spans: 20 + 1480 in the first call's, 20 + 180 + 400 in the second's
    assert fid_readers.unspanned_idle_share(ctx) == pytest.approx(
        100 * (1e6 - 1900 - 2100) / (1e6 - 1900))


def test_inception_flops():
    """11,422,336,192 convolution FLOPs an image at 299 x 299 (2 a
    multiply-add), 8,967,488 convolution outputs, 94 convolutions; a batch
    of 64 is bound by its FLOPs; a call of 5000 images runs 78 batches of 64
    and one of 8."""
    table = inception_flops.conv_table()
    assert len(table) == 94
    assert inception_flops.image_flops() == 11_422_336_192
    assert sum(o * h * w for _, _, o, _, _, h, w in table) == 8_967_488
    assert inception_flops.n_params() == 21_751_136 + 4 * sum(r[2] for r in table)
    assert inception_flops.forward_bound_s(64)[1] == "flops"
    assert inception_flops.call_batches(5000, 64) == [64] * 78 + [8]
