"""Seconds a pair in the record (postprocess.extend_beyond_range and
compute_ts_equal_cost_ranges, AlignmentResult.new)."""


def read(run):
    spans = [s for s in run.spans if s[0].startswith("record.")]
    if not run.n_pairs or not spans:
        return None
    return sum(b - a for _, a, b, _ in spans) / 1e9 / run.n_pairs
