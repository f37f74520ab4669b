"""The control of a cell's comparison: the plain reference put in the
program's place and computed in TF32 (float32 products on the tensor cores,
the nearest precision below the float32 the configurations state), held to
the float64 reference by the same numbers and limits as the program.  Each
number has to fail in some cell's control for its limit to mean anything.

    python3 port_bench/control.py --workload mcpc_fid.train --seeds 11 12 13

Prints one JSON line a seed: the numbers, their limits and whether the
control came out correct (it must not).  Needs a card; the CPU tests run the
same function with TF32 products emulated (``port_bench/tests``).
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from port_bench.lib.cell import entry_module, load_cell

    if not torch.cuda.is_available():
        print("the control runs on a card", file=sys.stderr)
        return 3
    cell = load_cell(args.workload)
    entry = entry_module(cell)
    torch.backends.cuda.matmul.allow_tf32 = True  # float64 products are not affected
    for seed in args.seeds:
        t0 = time.perf_counter()
        numbers = entry.control(cell, seed, torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": all(n.ok for n in numbers),
                          "seconds": time.perf_counter() - t0,
                          "numbers": {n.name: {"value": n.value, "limit": n.limit}
                                      for n in numbers}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
