"""Spans and counters at the port's layer boundaries, off by default.

    from tsalign_tpu_torch import tracing
    tracing.enable()
    tsalign_tpu_torch.align(r, q, device="cuda")
    spans, counts = tracing.take()   # what was recorded since, then cleared
    tracing.disable()

Off, `span` returns one shared no-op context and `count` returns at once:
one check of the module's `enabled` flag each, no clock read, nothing kept.
On, a span keeps ``(name, start_ns, end_ns, parent, call, attrs)``: times on
``time.time_ns()`` (the clock torch.profiler puts the device's events on),
`parent` the index in the list of the span that was open when it started
(-1 for none), `call` the id of its call.  A span opened while none is open
starts a new call, so every span of one ``align`` or ``align_pairs`` call
(whose `facade.call` span is the root) shares one id.  Counts are kept per
call, ``{call: {name: n}}``; a count made while no span is open goes to
call 0.  Spans are listed in the order they started.

``enable(profiler_ranges=True)`` also makes every span a
``torch.profiler.record_function`` range while torch.profiler records, so
the profiler's trace shows the program's spans over the kernels (the
command line's ``--profile``).

The program runs one host thread: nothing here locks.
"""

from __future__ import annotations

import functools
import sys
import time

enabled = False
_ranges = False

_spans: list = []
_counts: dict = {}
_stack: list = []  # indices of the open spans, innermost last
_call = 0
_next_call = 1


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("rec", "profiled")

    def __init__(self, name, attrs):
        self.rec = [name, 0, 0, -1, 0, attrs]
        self.profiled = None

    def __enter__(self):
        global _call, _next_call
        rec = self.rec
        if _stack:
            rec[3] = _stack[-1]
        else:
            _call, _next_call = _next_call, _next_call + 1
        rec[4] = _call
        _stack.append(len(_spans))
        _spans.append(rec)
        if _ranges and _profiler_on():
            from torch.profiler import record_function

            self.profiled = record_function(rec[0])
            self.profiled.__enter__()
        rec[1] = time.time_ns()
        return self

    def __exit__(self, *exc):
        global _call
        self.rec[2] = time.time_ns()
        if self.profiled is not None:
            self.profiled.__exit__(*exc)
        if _stack:
            _stack.pop()
            if not _stack:
                _call = 0
        return False


def _profiler_on() -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and torch.autograd.profiler._is_profiler_enabled


def span(name: str, **attrs):
    """A context that records the span `name` with `attrs` while tracing is
    on (the shared no-op context while it is off)."""
    if not enabled:
        return _NO_SPAN
    return _Span(name, attrs)


def spanned(name: str):
    """Decorate a function whose every call is the span `name` (no
    attributes); off, the call costs one check more."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not enabled:
                return fn(*args, **kwargs)
            with _Span(name, {}):
                return fn(*args, **kwargs)
        return wrapper
    return deco


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` of the open call while tracing is on."""
    if not enabled:
        return
    per_call = _counts.setdefault(_call, {})
    per_call[name] = per_call.get(name, 0) + n


def enable(profiler_ranges: bool = False) -> None:
    global enabled, _ranges
    enabled, _ranges = True, profiler_ranges


def disable() -> None:
    global enabled
    enabled = False


def take():
    """(spans, counts) recorded since the last `take`, and clear them: spans
    as tuples ``(name, start_ns, end_ns, parent, call, attrs)``, counts as
    ``{call: {name: n}}``.  Call it between calls, with no span open."""
    global _spans, _counts
    spans, counts = [tuple(s) for s in _spans], _counts
    _spans, _counts = [], {}
    _stack.clear()
    return spans, counts
