#!/usr/bin/env python3
"""Runs one cell of the benchmark of the PyTorch/CUDA port once.

    python3 portbench/run.py --workload <config>.<traffic> --seed N --seconds S --trace 0|1

From the root of a checkout, on a machine with the cards the cell asks for.
Set-up builds or loads the port's kernels (in the checkout's own build
cache, tsalign_tpu_torch/_build/), makes the cell's pairs from the seed and
warms up on pairs the window never sees; the window then runs `--seconds`
of whole calls and ends when the last call returns; the records are checked
against the plain reference (portbench/reference/).  Lines before the last:
`# host {...}` (threads, CPU affinity, the card, its clocks beside the
window), `# pairs [...]` and, on standard error, the numbers compared
against their limits.  The last line of standard output is the result.
Exits nonzero with no result where the card is missing, a piece of the cell
is missing, or a JAX module was loaded.
"""

import time

T_PROCESS = time.monotonic()  # set-up is counted from here (the interpreter's own start is not)

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))  # the checkout's root, where the port lives

from harness import cells, host  # noqa: E402  (neither imports torch)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        spec = cells.load(args.workload)
    except cells.Missing as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    host.set_thread_env(spec["config"].get("threads", {}))
    import torch

    chips = int(spec["cell"].get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    from harness import bench

    res = bench.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                         device="cuda", t_process=T_PROCESS, spec=spec)
    found = bench.forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or of the JAX package were loaded: {found}",
              file=sys.stderr)
        return 4
    print("# host " + json.dumps(res.pop("host")))
    print("# pairs " + json.dumps(res.pop("pairs")))
    compared = res["compared"]
    for name, c in compared.items():
        print(f"compared {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
