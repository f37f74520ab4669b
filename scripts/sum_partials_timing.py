"""Time the pass that sums the partial gradients, two ways, on one GPU.

    python3 scripts/sum_partials_timing.py [--blocks 15 16] [--n 120356]

For each number of partials it prints, as medians of 20 calls after a
warm-up, the time of ``sum_block_partials`` (the kernel), of
``sum_block_partials_reference`` (the plain version) and of
``torch.sum(partials, 0)``:

  host-paced    one call between two CUDA events, the host waiting for the
                second before the next call: the device idles while the host
                prepares the launch, so this is mostly the caller's host time;
  device        the 20 calls enqueued behind a kernel that spins for some
                25 ms, each between two events: the work on the device alone;
  back to back  3000 calls with no waiting in between, by the host's clock,
                the best of 3 such loops: the larger of the host's and the
                device's time per call, which is what a training loop pays.

It uses only what every version of the port since the summing pass has, so a
copy of it placed in an older checkout's ``scripts/`` times that checkout's
kernel; run both one after the other on one card to compare them.  Needs a CUDA
device and nvcc; there is no CPU mode.
"""

from __future__ import annotations

import argparse
import importlib
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
chain = importlib.import_module("montecarlopredictivecoding_tpu_torch.ops.mcpc_chain")

REPS = 20


def host_paced_ms(fn) -> float:
    fn()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(REPS)]
    torch.cuda._sleep(50_000_000)
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def back_to_back_ms(fn, calls: int = 3000) -> float:
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        start = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - start) / calls)
    return 1e3 * best


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--blocks", type=int, nargs="+", default=[15, 16])
    parser.add_argument("--n", type=int, default=120356)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("sum_partials_timing: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip())
    gen = torch.Generator().manual_seed(args.seed)
    for blocks in args.blocks:
        partials = (torch.randn(blocks, args.n, generator=gen) * 1e3).cuda()
        same = torch.equal(chain.sum_block_partials(partials),
                           chain.sum_block_partials_reference(partials))
        calls = {
            "kernel": lambda: chain.sum_block_partials(partials),
            "plain": lambda: chain.sum_block_partials_reference(partials),
            "torch.sum": lambda: partials.sum(dim=0),
        }
        for measure, timer in ((f"host-paced ms (median of {REPS})", host_paced_ms),
                               (f"device ms (median of {REPS})", device_ms),
                               ("back to back ms a call", back_to_back_ms)):
            print(f"[{blocks}, {args.n}] {measure}: "
                  + ", ".join(f"{name} {timer(fn):.4f}" for name, fn in calls.items())
                  + f"; kernel equals the ordered sum bit for bit: {same}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
