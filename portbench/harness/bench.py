"""One run of one cell: set-up, the measured window, the check, the result.

The window is a closed loop of one client: it starts calls of the cell's
entry (``tsalign_tpu_torch.align`` with the configuration's settings) on
fresh pairs until `seconds` have passed, and ends when the last call it
started returns.  `pair_s` is the window's wall over the pairs it completed.
Set-up makes the traffic's `pool` of pairs; a window that outruns it makes
the next `pool` with its clock stopped, so that only the program's work is
timed.
With `trace` the same window runs under the tracer and torch.profiler, and
the per-layer metrics are read from them.
"""

from __future__ import annotations

import gc
import sys
import time

import torch

from . import cells, check, host, trace, traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "tsalign_tpu")  # top-level module names, whole


class Run:
    """What a traced window leaves for the per-layer readers."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def forbidden_modules():
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def run_cell(workload: str, seed: int, seconds: float, traced: bool, *, device: str = "cuda",
             t_process: float | None = None, spec: dict | None = None) -> dict:
    """The result of one run (the keys of the benchmark's last line, and
    `host` and `pairs` for the lines before it).  `spec` replaces the cell's
    pieces from the files (the CPU tests run small traffic through it)."""
    t_process = time.monotonic() if t_process is None else t_process
    spec = spec or cells.load(workload)
    cfg, tr = spec["config"], spec["traffic"]
    host.set_torch_threads(cfg.get("threads", {}))
    stages = {"start": time.monotonic() - t_process}
    import tsalign_tpu_torch

    if device == "cuda":
        from tsalign_tpu_torch import _build

        torch.cuda.init()
        stages["cuda_init"] = time.monotonic() - t_process
        _build.library()  # the kernels, built once into the checkout's own cache
    stages["kernels"] = time.monotonic() - t_process
    warm = traffic.pairs(seed, traffic.WARMUP, int(tr["warmup_calls"]), tr)
    pool = traffic.Pairs(seed, traffic.WINDOW, tr, int(tr["pool"]))
    stages["pairs"] = time.monotonic() - t_process
    settings = dict(cfg["aligner"])

    def call(ref, qry):
        return tsalign_tpu_torch.align(ref, qry, device=device, **settings)

    for ref, qry in warm:
        call(ref, qry)
    if device == "cuda":
        torch.cuda.synchronize()
    stages["warm_up"] = time.monotonic() - t_process
    host_record = host.record(cfg.get("threads", {}))
    stages["host_record"] = time.monotonic() - t_process
    tracer = prof = None
    if traced:
        tracer = trace.Tracer()
        tracer.install()
        if device == "cuda":
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.start()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    sampler = host.Sampler()
    if device == "cuda":
        sampler.start()
    gc.collect()
    records, walls, errors = [], [], []
    made_s = 0.0  # pairs made inside the window, where it outruns the pool: not the program's
    t_start = time.monotonic()
    setup_s = t_start - t_process
    ns_start = time.time_ns()
    try:
        while time.monotonic() - t_start - made_s < seconds:
            k = len(walls)
            if k == len(pool):
                t_made = time.monotonic()
                pool.extend(int(tr["pool"]))
                made_s += time.monotonic() - t_made
            if tracer is not None:
                tracer.pair = k
            ref, qry = pool[k]
            t0 = time.monotonic()
            try:
                res = call(ref, qry)
            except Exception as e:  # a failed call counts as failed, and the window goes on
                res = None
                errors.append(f"pair {k}: {type(e).__name__}: {e}")
            walls.append(time.monotonic() - t0)
            records.append(res)
    finally:
        window_s = time.monotonic() - t_start - made_s
        ns_end = time.time_ns()
        if prof is not None:
            torch.cuda.synchronize()
            prof.stop()
        if tracer is not None:
            tracer.uninstall()
        clocks = sampler.stop() if device == "cuda" else {"samples": 0}
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    n = len(records)
    ok = [r for r in records if r is not None and r.has_target()]
    failed = n - len(ok)
    result = {"attempted": n, "failed": failed}
    device_info = {"platform": "gpu" if device == "cuda" else device,
                   "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
                   "count": int(spec["cell"].get("chips", 1)), "memory_peak_bytes": int(peak)}
    pairs_info = [{"wall_s": w} for w in walls]
    metrics = {}
    breakdown = None
    if not traced:
        if len(ok):
            metrics["pair_s"] = {"value": window_s / len(ok), "unit": "s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    else:
        t_read = time.monotonic()
        run = _traced_run(tracer, prof, device, walls, len(ok), ns_start, ns_end, peak, made_s)
        trace_info = dict(run.clock, read_s=time.monotonic() - t_read)
        for i, p in enumerate(pairs_info):
            p["passes"] = tracer.passes.get(i, 0)
            p["rounds"] = tracer.rounds.get(i, [])
        device_info["busy_s"] = run.busy_s
        device_info["window_s"] = run.window_s
        for m in spec["per_layer"]:
            value = cells.reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = run.breakdown
    # the program's state goes before the reference takes the card
    del prof, tracer
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_check = time.monotonic()
    counts = {}
    counts["pairs_made_in_window"] = len(pool) - int(tr["pool"])
    counts["made_in_window_s"] = made_s
    compared, counts_check = check.compare(cfg, seed, pool, records, walls, device)
    counts.update(counts_check)
    counts["check_s"] = time.monotonic() - t_check
    result.update(correct=all(c["value"] <= c["limit"] for c in compared.values()),
                  metrics=metrics, device=device_info)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = compared
    if traced:
        counts["trace"] = trace_info
    result["host"] = dict(host_record, window_clocks=clocks, window_s=window_s,
                          setup_s=setup_s, setup_stages_s=stages, errors=errors[:5], **counts)
    result["pairs"] = pairs_info
    return result


def _traced_run(tracer, prof, device, walls, n_ok, ns_start, ns_end, peak, made_s) -> Run:
    window_s = (ns_end - ns_start) / 1e9 - made_s
    events = trace.device_events(prof) if device == "cuda" else []
    busy = trace.merge([(a, b) for _, a, b in events], ns_start, ns_end)
    busy_s = sum(b - a for a, b in busy) / 1e9
    by_kernel = {}
    for name, a, b in events:
        k = trace.short_name(name)
        by_kernel[k] = by_kernel.get(k, 0.0) + (b - a) / 1e9
    idle = trace.idle_by_span(busy, tracer.spans, ns_start, ns_end)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    clock = {"device_events": len(events)}
    if events:  # the profiler's clock against the host's: both ends inside the window
        clock["first_event_after_start_s"] = (min(a for _, a, _ in events) - ns_start) / 1e9
        clock["last_event_before_end_s"] = (ns_end - max(b for _, _, b in events)) / 1e9
    return Run(
        clock=clock, n_pairs=n_ok, walls=walls, spans=tracer.spans, passes=dict(tracer.passes),
        rounds=dict(tracer.rounds), window_s=window_s, busy_s=busy_s,
        kernel_s=by_kernel, peak_bytes=peak,
        scan_least_s=float(tracer.scan_least) if tracer.scan_launches else None,
        asm_least_s=float(tracer.asm_least) if tracer.asm_launches else None,
        self_seconds=lambda name: trace.self_seconds(tracer.spans, name),
        breakdown={"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in gaps]},
    )
