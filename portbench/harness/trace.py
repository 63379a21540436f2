"""The traced run's instruments, all from the benchmark's side.

`Tracer` wraps calls into the port's layers (the facade, its engine pass,
the rounds loop, the host bounds, the traceback, the record, the two
kernels' wrappers) with spans on the host clock, counts engine passes and
rounds a pair, and works out the least time of each module-scan and
assembly launch from the work its inputs need (`roofline.py`).  The device's
work comes from torch.profiler (CUDA activity only, kept in memory), whose
event times are on the same clock as `time.time_ns()`.  Nothing here runs in
an untraced run.
"""

from __future__ import annotations

import functools
import time
from collections import defaultdict

from . import roofline

SCAN_KERNEL = "module_scan_kernel"
ASSEMBLY_KERNEL = "assembly_kernel"
BASE_SPAN = "harness.window"  # the host between the calls of the window


class Tracer:
    def __init__(self):
        self.spans = []  # (name, start_ns, end_ns, pair)
        self.pair = None
        self.passes = defaultdict(int)
        self.rounds = defaultdict(list)
        # summed least seconds of the launches (a device scalar for the
        # module scan, whose skipping mode's work is read from its output)
        self.scan_least, self.scan_launches = 0.0, 0
        self.asm_least, self.asm_launches = 0.0, 0
        self._asm_memo = {}
        self._patches = []

    def _wrap(self, owner, attr, name, on_result=None):
        raw = owner.__dict__[attr] if isinstance(owner, type) else getattr(owner, attr)
        is_cm = isinstance(raw, classmethod)
        fn = raw.__func__ if is_cm else raw
        tracer = self

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            t0 = time.time_ns()
            try:
                out = fn(*args, **kwargs)
            finally:
                tracer.spans.append((name, t0, time.time_ns(), tracer.pair))
            if on_result is not None:
                on_result(args, kwargs, out)
            return out

        setattr(owner, attr, classmethod(wrapper) if is_cm else wrapper)
        self._patches.append((owner, attr, raw))

    def install(self) -> None:
        import tsalign_tpu_torch.aligner as aligner
        import tsalign_tpu_torch.engine as engine
        import tsalign_tpu_torch.lower_bounds as lower_bounds
        import tsalign_tpu_torch.ops.assembly as assembly
        import tsalign_tpu_torch.ops.module_scan as module_scan
        import tsalign_tpu_torch.parallel.batch_ts as batch_ts
        import tsalign_tpu_torch.postprocess as postprocess
        import tsalign_tpu_torch.result as result
        import tsalign_tpu_torch.traceback as traceback

        w = self._wrap
        w(aligner.Aligner, "align", "facade.align")
        w(aligner.Aligner, "_run_engine_raw", "facade.engine_pass", self._count_pass)
        w(engine.TorchAligner, "align", "rounds.align", self._count_rounds)
        w(engine, "compute_remaining_bound", "bounds.remaining_bound")
        w(lower_bounds, "compute_remaining_bound", "bounds.remaining_bound")
        w(traceback.TracebackEngine, "trace", "traceback.trace")
        w(postprocess, "compute_ts_equal_cost_ranges", "record.postprocess")
        w(postprocess, "extend_beyond_range", "record.postprocess")
        w(result.AlignmentResult, "new", "record.result")
        w(module_scan, "module_scan", "kernels.module_scan", self._scan(False))
        w(module_scan, "module_scan_diag", "kernels.module_scan", self._scan(True))
        w(batch_ts, "module_scan_diag", "kernels.module_scan", self._scan(True))
        w(assembly, "assembly_fold", "kernels.assembly", self._assembly)

    def uninstall(self) -> None:
        for owner, attr, raw in reversed(self._patches):
            setattr(owner, attr, raw)
        self._patches.clear()

    def _count_pass(self, args, kwargs, out):
        self.passes[self.pair] += 1

    def _count_rounds(self, args, kwargs, out):
        self.rounds[self.pair].append(int(out.rounds))

    def _scan(self, diag):
        def on_result(args, kwargs, out):
            if out.device.type != "cuda":
                return
            n_bytes, ops = roofline.module_scan_work(
                args[:8], out, allow_sdel=kwargs["allow_sdel"],
                skip_from=0 if diag else kwargs.get("skip_from", 0), diag=diag)
            self.scan_least = self.scan_least + roofline.least_seconds(n_bytes, ops)
            self.scan_launches += 1
        return on_result

    def _assembly(self, args, kwargs, out):
        Bs, A_chunks, kms, ts, slabs, dest_base = args[:6]
        dest = args[6] if len(args) > 6 else kwargs.get("dest")
        if A_chunks[0].device.type != "cuda":
            return
        C, S = A_chunks[0].shape[1], kms[0].S
        if dest is None:
            spans = [C + S - 1] * len(kms)
        else:
            import numpy as np

            d = np.asarray(dest, dtype=np.int64)
            spans = list(d.max(axis=1) - d.min(axis=1) + S)
        n_bytes = ops = 0
        for A, km, span in zip(A_chunks, kms, spans):
            # what the count reads of a kind module, and no reference to it
            # (a module holds its pair's tables on the card)
            key = (A.shape[0], C, int(span), km.L_read, km.same_seq, km.S, km.anti_lo,
                   km.ah_real if km.padded else km.anti_hi,
                   tuple((p.a, p.b, p.positive) for p in km.plans))
            if key not in self._asm_memo:
                self._asm_memo[key] = roofline.assembly_work([A], [km], [span])
            b, o = self._asm_memo[key]
            n_bytes += b
            ops += o
        self.asm_least += roofline.least_seconds(n_bytes, ops)
        self.asm_launches += 1


def short_name(kernel: str) -> str:
    """A device operation's name without its return type, namespaces,
    template arguments and parameters: ``void (anonymous
    namespace)::module_scan_kernel<32, true>(...)`` -> ``module_scan_kernel``."""
    name = kernel.replace("(anonymous namespace)::", "").strip()
    if name.startswith("void "):
        name = name[5:]
    name = name.split("(")[0].split("<")[0].strip()
    return name.split("::")[-1] if name else kernel.strip()


def device_events(prof):
    """[(name, start_ns, end_ns)] of the work the device ran in the trace."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def merge(intervals, t0, t1):
    """The union of [a, b) intervals, clipped to [t0, t1], sorted."""
    out = []
    for a, b in sorted((max(a, t0), min(b, t1)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def innermost(spans, t0, t1):
    """[(a, b, name)] covering [t0, t1]: the innermost host span at each time
    (spans of one thread nest), BASE_SPAN outside every span."""
    segs = []
    stack = [(BASE_SPAN, t0, t1)]
    cursor = t0

    def emit(upto):
        nonlocal cursor
        if upto > cursor:
            segs.append((cursor, upto, stack[-1][0]))
            cursor = upto

    for name, a, b, _ in sorted(spans, key=lambda s: (s[1], -s[2])):
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        while len(stack) > 1 and stack[-1][2] <= a:
            emit(stack[-1][2])
            stack.pop()
        emit(a)
        stack.append((name, a, b))
    while stack:
        emit(stack[-1][2])
        stack.pop()
    return segs


def idle_by_span(busy, spans, t0, t1):
    """{span name: seconds the device was idle while it was the host's
    innermost span}."""
    gaps = []
    cursor = t0
    for a, b in busy:
        if a > cursor:
            gaps.append((cursor, a))
        cursor = max(cursor, b)
    if cursor < t1:
        gaps.append((cursor, t1))
    out = defaultdict(float)
    segs = innermost(spans, t0, t1)
    i = 0
    for a, b in gaps:
        while i < len(segs) and segs[i][1] <= a:
            i += 1
        k = i
        while k < len(segs) and segs[k][0] < b:
            lo, hi = max(a, segs[k][0]), min(b, segs[k][1])
            if hi > lo:
                out[segs[k][2]] += (hi - lo) / 1e9
            k += 1
    return out


def self_seconds(spans, name):
    """The summed duration of the spans `name`, less the time their child
    spans cover."""
    total = 0
    ordered = sorted(spans, key=lambda s: (s[1], -s[2]))
    for idx, (n, a, b, _) in enumerate(ordered):
        if n != name:
            continue
        kids = []
        for _, ca, cb, _ in ordered[idx + 1:]:
            if ca >= b:
                break
            kids.append((ca, cb))
        covered = sum(hi - lo for lo, hi in merge(kids, a, b))
        total += (b - a) - covered
    return total / 1e9
