"""Faults planted in the timed path underneath a run, for the check's own
tests (tests/test_portbench_faults.py, on the CPU) and for reading the
check's numbers under each fault on the card (control.py).

    with planted("cost_off_by_one", config):
        bench.run_cell(...)

`control` is the check's control: the plain reference's optimum under the
other side of the configuration's guarantee on template switches (none
where it allows them, any where it allows none), put in the program's place
as each pair's cost.  The cells call one pair at a time on one card, so of
the faults a cell can have these are the ones that apply: an answer altered
where it is produced (the cost, or one step of the alignment), no answer,
and a step that returns its state unchanged (the rounds loop left at its
root sweep, for a configuration that allows template switches).
"""

import contextlib


def _control(aligner, config):
    from tsalign_tpu_torch.alphabet import get_alphabet

    from reference import dp

    orig = aligner.Aligner._run_engine
    no_ts = not config["aligner"].get("no_ts", False)

    def broken(self, ref_arr, qry_arr, *a, **k):
        import torch

        _, alignment = orig(self, ref_arr, qry_arr, *a, **k)
        al = get_alphabet(self.alphabet)
        cost, _ = dp.solve(config["costs"], al.decode(ref_arr), al.decode(qry_arr), no_ts=no_ts,
                           device="cuda" if torch.cuda.is_available() else "cpu", K=1)
        return cost, alignment
    return "_run_engine", broken


def _cost_off_by_one(aligner, config):
    orig = aligner.Aligner._run_engine

    def broken(self, *a, **k):
        cost, alignment = orig(self, *a, **k)
        return cost + 1, alignment
    return "_run_engine", broken


def _match_relabelled(aligner, config):
    orig = aligner.Aligner._run_engine

    def broken(self, *a, **k):
        cost, alignment = orig(self, *a, **k)
        e = alignment.entries
        k0 = next(i for i, (_, t) in enumerate(e) if t == "PrimaryMatch")
        alignment.entries = e[:k0] + [(1, "PrimarySubstitution")] + (
            [(e[k0][0] - 1, "PrimaryMatch")] if e[k0][0] > 1 else []) + e[k0 + 1:]
        return cost, alignment
    return "_run_engine", broken


def _no_answer(aligner, config):
    from tsalign_tpu_torch.alignment import Alignment
    from tsalign_tpu_torch.costs import INF

    return "_run_engine", lambda self, *a, **k: (INF, Alignment([]))


def _rounds_left_at_root(aligner, config):
    orig = aligner.Aligner._run_engine_raw

    def broken(self, cfg, ref, qry, range_, max_ts, *a, **k):
        return orig(self, cfg, ref, qry, range_, 0, *a, **k)
    return "_run_engine_raw", broken


FAULTS = {
    "control": _control,
    "cost_off_by_one": _cost_off_by_one,
    "match_relabelled": _match_relabelled,
    "no_answer": _no_answer,
    "rounds_left_at_root": _rounds_left_at_root,
}


def applies(name: str, config: dict) -> bool:
    return name != "rounds_left_at_root" or not config["aligner"].get("no_ts", False)


@contextlib.contextmanager
def planted(name: str, config: dict):
    import tsalign_tpu_torch.aligner as aligner

    attr, broken = FAULTS[name](aligner, config)
    orig = aligner.Aligner.__dict__[attr]
    setattr(aligner.Aligner, attr, broken)
    try:
        yield
    finally:
        setattr(aligner.Aligner, attr, orig)
