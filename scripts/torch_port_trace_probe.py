#!/usr/bin/env python3
"""The port's own spans and counters over a window of a benchmark cell's
traffic, and what they cost.

    python3 scripts/torch_port_trace_probe.py --workload nots-default.twin160 \
        --seed 3000000041 --seconds 51
    python3 scripts/torch_port_trace_probe.py --workload nots-default.twin160 \
        --seed 3000000047 --cost 24 400

The window calls ``tsalign_tpu_torch.align`` with the cell's settings on
the cell's pairs (``portbench/harness`` makes them, and sets the threads, as
the benchmark does; nothing of it is changed), after the benchmark's
warm-up, with ``tsalign_tpu_torch.tracing`` on and, on the card,
torch.profiler recording the card's work.  It prints one JSON line: a pair,
the counters (device reads, KiB up and down, engine passes, rounds, the
rounds loops that the k * delta stop ended, and the traceback's template
switches explained, candidates priced and hits its forward column did not
confirm) and the seconds in device reads
(`device.read`), in the engine's tables and root seeds (`engine.tables`,
`engine.seeds`) and in the traceback's own walk (`traceback.trace` less its
children, which are its row-block reads and its module DPs); the spans a
pair by name; and the card's idle seconds by the innermost program span
(``harness.window`` between calls), with the share of the window idle under
``rounds.align``, ``facade.align`` and ``facade.engine_pass`` themselves.

``--cost BLOCKS PER`` runs instead BLOCKS blocks of PER pairs, the program's
tracing off and on in turns (off, on, on, off, ...), and prints the wall a
pair of each block, and the host's cost of a span site, of a decorated call
and of a count while tracing is off.
"""

import argparse
import json
import os
import statistics
import sys
import time
import timeit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "portbench"), ROOT]

from harness import cells, host  # noqa: E402  (neither imports torch)

SPAN_SHARES = {"read_wait_s": ("device.read",), "engine_prep_s": ("engine.tables", "engine.seeds")}
OWN_IDLE = ("rounds.align", "facade.align", "facade.engine_pass")
COUNTS = {"engine_passes": "facade.engine_passes", "rounds": "rounds.rounds",
          "kdelta_stops": "rounds.kdelta_stops", "tsm_reconstructs": "traceback.tsm_reconstructs",
          "tsm_candidates": "traceback.tsm_candidates",
          "tsm_confirm_misses": "traceback.tsm_confirm_misses"}


def window(spec, seed, seconds, device):
    import torch

    from harness import trace, traffic
    import tsalign_tpu_torch
    from tsalign_tpu_torch import tracing

    tr, settings = spec["traffic"], dict(spec["config"]["aligner"])
    for r, q in traffic.pairs(seed, traffic.WARMUP, int(tr["warmup_calls"]), tr):
        tsalign_tpu_torch.align(r, q, device=device, **settings)
    pool = traffic.pairs(seed, traffic.WINDOW, int(seconds * 400) + 100, tr)
    prof = None
    if device == "cuda":
        torch.cuda.synchronize()
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.start()
    tracing.take()
    tracing.enable()
    n = 0
    t0, ns_start = time.monotonic(), time.time_ns()
    while time.monotonic() - t0 < seconds and n < len(pool):
        tsalign_tpu_torch.align(*pool[n], device=device, **settings)
        n += 1
    ns_end = time.time_ns()
    tracing.disable()
    spans, counts = tracing.take()
    if prof is not None:
        torch.cuda.synchronize()
        prof.stop()
    window_s = (ns_end - ns_start) / 1e9

    totals = {}
    for per_call in counts.values():
        for name, v in per_call.items():
            totals[name] = totals.get(name, 0) + v
    host_spans = [(name, a, b, call) for name, a, b, _, call, _ in spans]
    by_name = {}
    for name, *_ in spans:
        by_name[name] = by_name.get(name, 0) + 1

    def union_s(names):
        return sum(b - a for a, b in trace.merge(
            [(a, b) for name, a, b, _ in host_spans if name in names], ns_start, ns_end)) / 1e9

    out = {"workload": spec["cell"]["name"], "seed": seed, "device": device, "pairs": n,
           "window_s": window_s,
           "a_pair": {"device_reads": totals.get("device.reads", 0) / n,
                      "h2d_kib": totals.get("copy.h2d_bytes", 0) / 1024 / n,
                      "d2h_kib": totals.get("copy.d2h_bytes", 0) / 1024 / n,
                      **{k: totals.get(name, 0) / n for k, name in COUNTS.items()},
                      **{k: union_s(v) / n for k, v in SPAN_SHARES.items()},
                      "traceback_walk_s": trace.self_seconds(host_spans, "traceback.trace") / n,
                      "spans": {k: v / n for k, v in sorted(by_name.items())}}}
    if prof is not None:
        events = trace.device_events(prof)
        busy = trace.merge([(a, b) for _, a, b in events], ns_start, ns_end)
        idle = trace.idle_by_span(busy, host_spans, ns_start, ns_end)
        out["busy_s"] = sum(b - a for a, b in busy) / 1e9
        out["idle_s_by_span"] = dict(sorted(idle.items(), key=lambda kv: -kv[1]))
        out["own_idle_share"] = sum(idle.get(k, 0.0) for k in OWN_IDLE) / window_s
    return out


def cost(spec, seed, blocks, per, device):
    from harness import traffic
    import tsalign_tpu_torch
    from tsalign_tpu_torch import tracing

    tr, settings = spec["traffic"], dict(spec["config"]["aligner"])
    pool = traffic.pairs(seed, traffic.WINDOW, blocks * per + 50, tr)
    for r, q in pool[:50]:
        tsalign_tpu_torch.align(r, q, device=device, **settings)
    walls = {"off": [], "on": []}
    at = 50
    for b in range(blocks):
        mode = "on" if b % 4 in (1, 2) else "off"
        if mode == "on":
            tracing.enable()
        t0 = time.perf_counter()
        for r, q in pool[at:at + per]:
            tsalign_tpu_torch.align(r, q, device=device, **settings)
        walls[mode].append((time.perf_counter() - t0) / per)
        at += per
        tracing.disable()
        tracing.take()

    def best(fn):
        return min(timeit.repeat(fn, number=200000, repeat=5)) / 200000

    def noop():
        pass

    def site():
        with tracing.span("x"):
            pass

    def counted():
        tracing.count("x")

    base = best(noop)
    return {"workload": spec["cell"]["name"], "seed": seed, "device": device, "per_block": per,
            "off_ms": [w * 1e3 for w in walls["off"]], "on_ms": [w * 1e3 for w in walls["on"]],
            "median_off_ms": statistics.median(walls["off"]) * 1e3,
            "median_on_ms": statistics.median(walls["on"]) * 1e3,
            "off_span_site_us": (best(site) - base) * 1e6,
            "off_decorated_call_us": (best(tracing.spanned("x")(noop)) - base) * 1e6,
            "off_count_us": (best(counted) - base) * 1e6}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--cost", type=int, nargs=2, metavar=("BLOCKS", "PER"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    spec = cells.load(args.workload)
    host.set_thread_env(spec["config"].get("threads", {}))
    import torch

    host.set_torch_threads(spec["config"].get("threads", {}))
    if args.device == "cuda":
        from tsalign_tpu_torch import _build

        torch.cuda.init()
        _build.library()
    if args.cost:
        out = cost(spec, args.seed, *args.cost, args.device)
    else:
        out = window(spec, args.seed, args.seconds, args.device)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
