"""Long-sequence chained alignment (lib_ts_chainalign counterpart).

TPU-first redesign: instead of the reference's anchor-graph A* with lazily
evaluated exact gap costs (lib_ts_chainalign/src/chain_align/chainer.rs),
long pairs are decomposed by a k-mer anchor chain into independent segments
whose cut points sit in the middle of confident exact-match runs; each
segment runs the dense TS engine (batched across segments on the device),
and the per-segment alignments concatenate exactly.  TSM locality is
guaranteed by the cost model's finite offset/length windows, so a segment
overlapped wider than the window radius contains every TSM whose entry lies
in its interior.
"""

from .driver import chain_align  # noqa: F401
