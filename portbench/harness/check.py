"""Decides `correct`: the records that the window produced against the plain
reference (`portbench/reference`), after the window has closed.

Compared, each with its limit:
  failed           calls of the window that raised or gave no alignment (0)
  cost_wrong       checked records whose cost is not the reference's optimum (0)
  alignment_wrong  checked records whose alignment is not an alignment of the
                   pair that prices to the optimum under the configuration (0)
  ts_length_short  under the maximise tie-break of the total template-switch
                   length (the aligner's default), checked records whose
                   total template-switch length is below the reference's
                   largest at the optimum cost (0)
The records checked are all of them, or, where the configuration's `check`
asks for `sample` records, the window's `slowest` slowest pairs (those with
the most rounds) and a draw from the seed's own stream of the others.
"""

from __future__ import annotations

from reference import dp, pricer

from . import traffic


def plain_ops(entries):
    """A record's alignment as the pricer reads it."""
    out = []
    for n, t in entries:
        if hasattr(t, "first_offset"):
            out.append((n, ("TemplateSwitchEntrance", t.primary, t.secondary, t.direction,
                            int(t.first_offset))))
        elif hasattr(t, "anti_primary_gap"):
            out.append((n, ("TemplateSwitchExit", int(t.anti_primary_gap))))
        else:
            out.append((n, str(t)))
    return out


def maximises(cfg: dict) -> bool:
    """Whether the configuration states the maximise tie-break."""
    a = cfg["aligner"]
    return (not a.get("no_ts", False)
            and a.get("template_switch_total_length_strategy", "maximise") == "maximise")


def sample(cfg: dict, seed: int, walls) -> list:
    n = len(walls)
    want = cfg.get("check", {}).get("sample", "all")
    if want == "all" or int(want) >= n:
        return list(range(n))
    n_slow = min(int(cfg["check"].get("slowest", 1)), int(want))
    slowest = sorted(range(n), key=lambda k: -walls[k])[:n_slow]
    others = [k for k in range(n) if k not in set(slowest)]
    rng = traffic.stream(seed, traffic.SAMPLE)
    picked = rng.choice(len(others), size=int(want) - n_slow, replace=False)
    return sorted(slowest + [others[int(i)] for i in picked])


def compare(cfg: dict, seed: int, pool, records, walls, device: str):
    """(compared, counts beside them) of a run's records."""
    no_ts = bool(cfg["aligner"].get("no_ts", False))
    idx = [k for k in sample(cfg, seed, walls) if records[k] is not None and records[k].has_target()]
    K = dp.TS_SCALE if maximises(cfg) else 1
    want = dp.solve_many(cfg["costs"], [pool[k] for k in idx], no_ts=no_ts, device=device, K=K)
    return judge(cfg, [pool[k] for k in idx], [records[k] for k in idx], want,
                 failed=sum(1 for r in records if r is None or not r.has_target()))


def judge(cfg, pairs, records, want, failed: int):
    cost_wrong = alignment_wrong = short = 0
    for (ref, qry), rec, (w_cost, w_tsl) in zip(pairs, records, want):
        got = rec.stats()["cost"]
        if w_cost is None or got != w_cost:
            cost_wrong += 1
        try:
            priced, tsl = pricer.price(cfg["costs"], ref, qry, plain_ops(rec.alignments()))
        except pricer.Invalid:
            alignment_wrong += 1
            continue
        if w_cost is None or priced != w_cost:
            alignment_wrong += 1
        elif tsl < w_tsl:
            short += 1
    compared = {
        "failed": {"value": failed, "limit": 0},
        "cost_wrong": {"value": cost_wrong, "limit": 0},
        "alignment_wrong": {"value": alignment_wrong, "limit": 0},
    }
    if maximises(cfg):
        compared["ts_length_short"] = {"value": short, "limit": 0}
    return compared, {"checked": len(records)}
