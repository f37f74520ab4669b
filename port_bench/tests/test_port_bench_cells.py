"""The harness at tiny sizes on the CPU: each cell kind runs and compares
correct; a configuration, a mix and a metric added as files are found
without editing any file; the result line's shape; no JAX is loaded."""

import json
import os
import shutil
import subprocess
import sys
import types

import pytest
import torch

from port_bench import run as bench
from port_bench.lib import cell as cells
from port_bench.lib.cell import BENCH_DIR
from port_bench.tests import tiny

ROOT = BENCH_DIR.parent
CPU = torch.device("cpu")


def setup_module():
    torch.set_num_threads(1)


@pytest.mark.parametrize("kind", ["train", "sample", "eval"])
def test_tiny_cell_is_correct(kind):
    res = bench.run(tiny.cell(kind), tiny.SEED, 0.3, False, CPU)
    w = res.pop("_window")
    assert w.items >= 1 and res["attempted"] == w.items and res["failed"] == 0
    assert res["correct"], res["limits"]
    assert set(res["metrics"]) == set(tiny.END_TO_END[kind]) | {"setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())


def test_benchmark_names_every_file():
    bench_json = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench_json["workloads"]:
        c = cells.load_cell(w["name"])
        assert c.dims[3] == 784 and cells.entry_module(c).KIND == w["traffic"]
    for m in bench_json["per_layer"]:
        assert cells.metric_reader(m["name"]) is not None, m["name"]


def test_added_files_are_found(tmp_path):
    """A later change adds a configuration, a mix and a metric as files and
    entries; the harness finds and runs them unedited."""
    shutil.copytree(BENCH_DIR, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench_json = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "port_bench" / "configs" / "tiny_model.json").write_text(json.dumps(tiny.SMALL))
    mix = json.loads((BENCH_DIR / "mixes" / "train.json").read_text())
    mix.update(tiny.SHRINK["train"])
    (tmp_path / "port_bench" / "mixes" / "tiny_train.json").write_text(json.dumps(mix))
    (tmp_path / "port_bench" / "layer_metrics" / "batches_seen.train.py").write_text(
        "def read(ctx):\n    return float(ctx.window.items)\n")
    bench_json["configs"].append({"name": "tiny_model", "source": "https://example.org",
                                  "file": "port_bench/configs/tiny_model.json",
                                  "reduced": [], "why": "test"})
    bench_json["workloads"].append({"name": "tiny_model.tiny_train", "config": "tiny_model",
                                    "traffic": "tiny_train", "chips": 1, "why": "test"})
    bench_json["per_layer"].append({"name": "batches_seen.train", "unit": "1",
                                    "better": "higher", "source": "program_counter",
                                    "layer": "entry points", "moves": "train_images_per_s",
                                    "workloads": ["tiny_model.tiny_train"]})
    for m in bench_json["end_to_end"]:
        if m["name"] in tiny.END_TO_END["train"]:
            m["workloads"].append("tiny_model.tiny_train")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench_json))

    c = cells.load_cell("tiny_model.tiny_train", root=tmp_path)
    assert c.dims == (4, 8, 8, 16) and c.mix["batch"] == 8
    assert "train_images_per_s" in [m["name"] for m in c.end_to_end]
    assert [m["name"] for m in c.per_layer] == ["batches_seen.train"]
    res = bench.run(c, tiny.SEED, 0.2, False, CPU, root=tmp_path)
    assert res["correct"]
    ctx = types.SimpleNamespace(window=res["_window"], timeline=None, cell=c, kind="train")
    got = bench.layer_metrics(c, ctx, root=tmp_path)
    assert got == {"batches_seen.train": {"value": float(res["_window"].items), "unit": "1"}}


def test_result_line_shape():
    res = bench.run(tiny.cell("train"), tiny.SEED, 0.2, False, CPU)
    res.pop("_window")
    line = bench.result_line(res, "NVIDIA H100 80GB HBM3")
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "limits"
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert {"memory_peak_bytes", "kind"} <= set(line["device"])
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert all(set(n) == {"value", "limit"} for n in line["limits"].values())
    json.loads(json.dumps(line))


def test_forbidden_names_are_compared_whole():
    assert bench.loaded_forbidden(["montecarlopredictivecoding_tpu_torch.ops", "jaxtyping",
                                   "flaxen", "torch"]) == []
    assert bench.loaded_forbidden(["montecarlopredictivecoding_tpu.core", "jax.numpy",
                                   "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "montecarlopredictivecoding_tpu"]


def test_a_run_loads_no_jax():
    """A tiny run in a fresh process leaves no forbidden module loaded, and
    the command line without a card prints no result and fails."""
    code = ("import sys, torch; sys.path.insert(0, %r); torch.set_num_threads(1)\n"
            "from port_bench import run as bench; from port_bench.tests import tiny\n"
            "bench.run(tiny.cell('sample'), 3, 0.1, False, torch.device('cpu'))\n"
            "print(bench.loaded_forbidden())\n") % str(ROOT)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
    cli = subprocess.run([sys.executable, str(BENCH_DIR / "run.py"), "--workload",
                          "mcpc_fid.train", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert cli.returncode == 3 and cli.stdout == ""


def test_command_fails_without_the_port(tmp_path):
    """In a folder that holds only BENCHMARK.json and the benchmark's files
    the command fails and prints no result."""
    shutil.copytree(BENCH_DIR, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "mcpc_fid.train",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
