#!/usr/bin/env python3
"""Rounds, engine passes and records of a template-switch cell's pairs,
each against the plain reference.

    python3 scripts/torch_port_ts_rounds_probe.py --workload ts-default.twin160-ts \
        --seeds 5000000021,5000000022,5000000023 --pairs 24 [--port DIR]

For each seed the first PAIRS pairs of the cell's window stream (the pairs a
window of the benchmark starts with) go through ``tsalign_tpu_torch.align``
with the cell's settings, after its warm-up calls, under the benchmark's
own `Tracer` (``portbench/harness/trace.py``), which counts each call's
engine passes and the rounds of each pass.  Each record's cost and total
template-switch length (``portbench/reference/pricer.py``) are compared
with ``portbench/reference/dp.py``.  `--port DIR` imports the port from the
checkout at DIR (another commit's, to compare two); `--pair REF,QRY` adds
one more pair.  Prints a JSON line a pair and a last line with the
histograms of rounds and passes, the pairs short of the reference's length
and the wall a pair.
"""

import argparse
import collections
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "portbench")]

from harness import cells, host  # noqa: E402  (neither imports torch)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="ts-default.twin160-ts")
    ap.add_argument("--seeds", default="")
    ap.add_argument("--pairs", type=int, default=24)
    ap.add_argument("--pair", action="append", default=[])
    ap.add_argument("--port", default=ROOT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(1, os.path.abspath(args.port))
    spec = cells.load(args.workload)
    host.set_thread_env(spec["config"].get("threads", {}))
    import torch

    host.set_torch_threads(spec["config"].get("threads", {}))
    import tsalign_tpu_torch
    from harness import check, trace, traffic
    from reference import dp, pricer

    assert os.path.dirname(os.path.abspath(tsalign_tpu_torch.__file__)).startswith(
        os.path.abspath(args.port))
    if args.device == "cuda":
        from tsalign_tpu_torch import _build

        torch.cuda.init()
        _build.library()
    cfg, tr = spec["config"], spec["traffic"]
    settings = dict(cfg["aligner"])
    no_ts = bool(settings.get("no_ts", False))
    work = []
    for seed in [int(s) for s in args.seeds.split(",")] if args.pairs else []:
        for r, q in traffic.pairs(seed, traffic.WARMUP, int(tr["warmup_calls"]), tr):
            tsalign_tpu_torch.align(r, q, device=args.device, **settings)
        work += [(seed, k, r, q) for k, (r, q) in
                 enumerate(traffic.pairs(seed, traffic.WINDOW, args.pairs, tr))]
    work += [(None, k, *p.split(",")) for k, p in enumerate(args.pair)]
    want = dp.solve_many(cfg["costs"], [(r, q) for *_, r, q in work], no_ts=no_ts,
                         device=args.device, K=dp.TS_SCALE if check.maximises(cfg) else 1)
    tracer = trace.Tracer()
    tracer.install()
    hist = {"rounds": collections.Counter(), "passes": collections.Counter()}
    short, wrong, walls = [], [], []
    try:
        for n, ((seed, k, r, q), (w_cost, w_tsl)) in enumerate(zip(work, want)):
            tracer.pair = n
            t0 = time.monotonic()
            rec = tsalign_tpu_torch.align(r, q, device=args.device, **settings)
            walls.append(time.monotonic() - t0)
            cost, tsl = pricer.price(cfg["costs"], r, q, check.plain_ops(rec.alignments()))
            rounds = tracer.rounds.get(n, [])
            hist["passes"][tracer.passes.get(n, 0)] += 1
            for x in rounds:
                hist["rounds"][x] += 1
            if cost != w_cost or rec.stats()["cost"] != w_cost:
                wrong.append(n)
            elif tsl < w_tsl:
                short.append(n)
            print(json.dumps({"seed": seed, "pair": k, "cost": rec.stats()["cost"],
                              "ref_cost": w_cost, "tsl": tsl, "ref_tsl": w_tsl,
                              "passes": tracer.passes.get(n, 0), "rounds": rounds,
                              "wall_s": walls[-1]}), flush=True)
    finally:
        tracer.uninstall()
    print(json.dumps({"port": os.path.abspath(args.port), "pairs": len(work),
                      "rounds_hist": dict(sorted(hist["rounds"].items())),
                      "passes_hist": dict(sorted(hist["passes"].items())),
                      "short": len(short), "wrong": len(wrong),
                      "mean_wall_s": sum(walls) / max(1, len(walls))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
