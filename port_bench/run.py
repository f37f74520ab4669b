"""The port's benchmark: one run of one cell on the card.

    python3 port_bench/run.py --workload mcpc_fid.train --seed 7 --seconds 10 --trace 0

The cell is found by name in ``BENCHMARK.json`` (``port_bench/lib/cell.py``
says where its files are).  A run makes the weights and images on the card
from ``--seed``, loads (or, the first time in a checkout, builds) the port's
kernels into ``build/torch_kernels/``, drives the cell's first batches as
set-up, measures for ``--seconds``, then holds what the window produced to
the plain reference (``port_bench/reference/``) and prints one JSON line.
With ``--trace 1`` the window runs under ``torch.profiler`` and the line
holds the cell's per-layer metrics, read by ``port_bench/layer_metrics/``;
with ``--trace 0`` it holds the end-to-end ones.

Exit codes: 0 with a result; 3 without a card (or with fewer than the cell
asks for); 4 where JAX or the JAX package was loaded; any other failure
raises.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "montecarlopredictivecoding_tpu")


def process_age() -> float:
    """Seconds since this process started, from /proc: set-up counts the
    interpreter's own start."""
    try:
        with open("/proc/self/stat") as f:
            after = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - int(after[19]) / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


AGE0 = process_age()


def loaded_forbidden(modules=None) -> list:
    """The forbidden top-level names among the loaded modules, compared
    whole (the port's name begins with the JAX package's)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def card_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "power limit not read"


def layer_metrics(cell, ctx, root=ROOT) -> dict:
    from port_bench.lib.cell import metric_reader

    out = {}
    for m in cell.per_layer:
        reader = metric_reader(m["name"], root)
        value = None if reader is None else reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run(cell, seed: int, seconds: float, traced: bool, device, root=ROOT) -> dict:
    """Set-up, window and comparison of one cell on ``device``, its files
    under ``root``: the result line's dict (without the device block's name
    and count; the window under ``_window``)."""
    import torch

    from port_bench.lib import trace
    from port_bench.lib.cell import entry_module

    on_card = device.type == "cuda"
    entry = entry_module(cell, root)
    span = trace.span if traced else trace.no_span
    st = entry.setup(cell, seed, device, span)
    if on_card:
        torch.cuda.synchronize()
    setup_s = AGE0 + time.perf_counter() - START
    with trace.traced(traced) as tr:
        with span(trace.WINDOW):
            w = entry.window(st, seconds, span)
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    entry.release(st)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers = entry.check(st)
    del st
    gc.collect()
    result = {"correct": all(n.ok for n in numbers), "attempted": w.attempted,
              "failed": w.failed, "metrics": {},
              "device": {"memory_peak_bytes": memory_peak}}
    if traced:
        tl = tr.timeline
        ctx = types.SimpleNamespace(timeline=tl, window=w, cell=cell, kind=entry.KIND)
        result["metrics"] = layer_metrics(cell, ctx, root)
        result["device"].update(busy_s=tl.busy_s, window_s=tl.window_s)
        result["breakdown"] = tl.breakdown()
    else:
        values = dict(w.end_to_end, setup_s=setup_s)
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end}
    result["limits"] = {n.name: {"value": n.value, "limit": n.limit} for n in numbers}
    result["_window"] = w
    return result


def result_line(result: dict, kind: str) -> dict:
    """The printed line: the keys the contract reads, the device block with
    the card's name, the compared numbers last."""
    line = {k: result[k] for k in ("correct", "attempted", "failed", "metrics")}
    line["device"] = {"platform": "gpu", "kind": kind, "count": 1, **result["device"]}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["limits"] = result["limits"]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ["USE_FLAX"] = "0"
    for var, sub in (("TRITON_CACHE_DIR", "triton_cache"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "build" / sub)
    sys.path.insert(0, str(ROOT))
    from port_bench.lib.cell import load_cell

    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = run(cell, args.seed, args.seconds, bool(args.trace), device)
    w = result.pop("_window")
    print(f"{args.workload}: {w.items} items in {w.seconds:.3f} s on "
          f"{torch.cuda.get_device_name(0)} ({card_limit()})", file=sys.stderr)
    if args.trace:
        from port_bench.reference import flops

        rate = w.flops / result["device"]["window_s"]
        print(f"model FLOP/s {rate:.6e}: {100 * rate / flops.PEAK_F32_FMA:.4f}% of the 67 TFLOP/s "
              f"f32 FMA peak, {100 * rate / flops.PEAK_F32_ACCURATE:.4f}% of the 165 TFLOP/s "
              f"f32-accurate peak", file=sys.stderr)
    found = loaded_forbidden()
    if found:
        print(f"loaded modules that the port must not load: {', '.join(found)}", file=sys.stderr)
        return 4
    result = result_line(result, torch.cuda.get_device_name(0))
    for name, n in result["limits"].items():
        verdict = "ok" if n["value"] <= n["limit"] else "FAILED"
        print(f"{name} {n['value']!r} limit {n['limit']!r} {verdict}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
