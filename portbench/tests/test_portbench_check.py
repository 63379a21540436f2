"""The check: the sample holds the window's slowest pairs and a draw from the
seed; under the maximise tie-break the total template-switch length is
compared with the limit 0, and without it not."""

from harness import check, traffic
from reference import dp
from small import config

TINY = {"length": 24, "margin": 4, "stretches": [{"count": 1, "length": 7}],
        "substitutions": 1, "deletions": 1, "insertions": 0}


def test_sample_holds_the_slowest_and_a_draw():
    cfg = {"check": {"sample": 5, "slowest": 2}}
    walls = [0.1] * 20
    walls[3], walls[17] = 5.0, 4.0
    idx = check.sample(cfg, 11, walls)
    assert len(idx) == len(set(idx)) == 5 and {3, 17} <= set(idx)
    assert idx == check.sample(cfg, 11, walls) and idx != check.sample(cfg, 12, walls)
    assert check.sample({"check": {"sample": "all"}}, 11, walls) == list(range(20))


def test_tie_break_compared_only_where_the_configuration_states_it():
    from tsalign_tpu_torch import align

    ref, qry = traffic.twin(traffic.stream(5, traffic.WINDOW), TINY)
    rec = align(ref, qry, device="cpu")
    maximise, anyone = config("ts-default"), config("ts-nomax")
    assert check.maximises(maximise) and not check.maximises(anyone)
    assert not check.maximises(config("nots-default"))
    cost, tsl = dp.solve(maximise["costs"], ref, qry, no_ts=False)
    compared, _ = check.judge(maximise, [(ref, qry)], [rec], [(cost, tsl)], failed=0)
    assert all(c["value"] == 0 for c in compared.values()), compared
    compared, _ = check.judge(maximise, [(ref, qry)], [rec], [(cost, tsl + 1)], failed=0)
    assert compared["ts_length_short"] == {"value": 1, "limit": 0}
    assert compared["cost_wrong"]["value"] == 0
    compared, _ = check.judge(anyone, [(ref, qry)], [rec], [(cost, 0)], failed=0)
    assert set(compared) == {"failed", "cost_wrong", "alignment_wrong"}
