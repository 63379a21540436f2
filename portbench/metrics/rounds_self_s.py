"""Host seconds a pair in the rounds loop (TorchAligner.align, the fused
loop included) outside its child spans (the host bounds, the kernels'
wrappers)."""


def read(run):
    if not run.n_pairs or not any(s[0] == "rounds.align" for s in run.spans):
        return None
    return run.self_seconds("rounds.align") / run.n_pairs
