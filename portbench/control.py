#!/usr/bin/env python3
"""Reads the benchmark's correctness check under its control and under each
planted fault (faults.py) that applies to a cell, on the card at the cell's
own size: for each, a window of S seconds on each seed, in one process, and
one line with `correct` and the numbers that the check compared.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--seconds S]

The control (`control` in faults.py) and every fault have to come out not
correct.  The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))  # the checkout's root, where the port lives

from harness import cells, host  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    spec = cells.load(args.workload)
    config = spec["config"]
    host.set_thread_env(config.get("threads", {}))
    import torch

    import faults
    from harness import bench

    device = "cuda" if torch.cuda.is_available() else "cpu"  # the CPU: the tests, at a small size

    for name in faults.FAULTS:
        if not faults.applies(name, config):
            continue
        for seed in (int(s) for s in args.seeds.split(",")):
            with faults.planted(name, config):
                res = bench.run_cell(args.workload, seed, args.seconds, False, device=device,
                                      spec=spec)
            print(json.dumps({"workload": args.workload, "fault": name, "seed": seed,
                              "correct": res["correct"], "attempted": res["attempted"],
                              **res["compared"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
