"""The plain reference against known costs: the JAX package's recorded
costs of the repository's 60-bp fixture pairs, and the program's Dijkstra
oracle (upstream's search graph) on tiny planted pairs; its tie-break
against an exhaustive label-correcting search of the K-scaled graph; the
pricer against the oracle's alignments and against altered ones."""

import heapq
import json
import os

import pytest

from harness import cells, check, traffic
from reference import dp, pricer
from small import config

COSTS = config("ts-default")["costs"]
TINY = {"length": 24, "margin": 4, "stretches": [{"count": 1, "length": 7}],
        "substitutions": 1, "deletions": 1, "insertions": 0}


def oracle_parts():
    from tsalign_tpu_torch.alphabet import get_alphabet
    from tsalign_tpu_torch.config import TemplateSwitchConfig
    from tsalign_tpu_torch.oracle import OracleAligner

    al = get_alphabet("dna-n")
    return al, TemplateSwitchConfig.default(al), OracleAligner


def plain(alignment):
    return check.plain_ops(alignment.entries)


with open(os.path.join(cells.ROOT, "tests", "fixtures", "torch_port_pairs.json")) as f:
    FIXTURE = json.load(f)["pairs"]


@pytest.mark.parametrize("pair", FIXTURE, ids=[p["name"] for p in FIXTURE])
def test_known_costs_of_the_fixture_pairs(pair):
    """60, 150 and 200 bp: about 1, 45 and 115 s on the CPU."""
    cost, _ = dp.solve(COSTS, pair["reference"], pair["query"], no_ts=False)
    assert cost == pair["cost"]


@pytest.mark.parametrize("seed", range(6))
def test_against_the_oracle(seed):
    al, cfg, Oracle = oracle_parts()
    ref, qry = traffic.twin(traffic.stream(seed, traffic.WINDOW), TINY)
    R, Q = al.encode(ref), al.encode(qry)
    cost, alignment = Oracle(cfg, R, Q).align()
    cost0, _ = Oracle(cfg, R, Q, max_template_switches=0).align()
    assert dp.solve(COSTS, ref, qry, no_ts=False, K=1)[0] == cost
    assert dp.solve(COSTS, ref, qry, no_ts=True)[0] == cost0
    assert pricer.price(COSTS, ref, qry, plain(alignment))[0] == cost


def exhaustive(oracle, limit):
    """The least value of the target over every path of value <= limit
    (label correcting: right with the tie-break's negative steps)."""
    root = oracle.root()
    dist, heap, count, best = {root: 0}, [(0, 0, root)], 1, None
    while heap:
        d, _, s = heapq.heappop(heap)
        if d != dist.get(s):
            continue
        if oracle.is_target(s):
            best = d if best is None else min(best, d)
        for inc, succ, _ in oracle.successors(s):
            if d + inc <= limit and d + inc < dist.get(succ, 2**62):
                dist[succ] = d + inc
                heapq.heappush(heap, (d + inc, count, succ))
                count += 1
    return best


@pytest.mark.parametrize("seed", [0, 3])
def test_tie_break_against_an_exhaustive_search(seed):
    al, cfg, Oracle = oracle_parts()
    ref, qry = traffic.twin(traffic.stream(seed, traffic.WINDOW), TINY)
    cost, tsl = dp.solve(COSTS, ref, qry, no_ts=False)
    K = 256
    comp = exhaustive(Oracle(cfg.scaled_for_length_tiebreak(K), al.encode(ref),
                             al.encode(qry)), K * cost)
    assert (cost, tsl) == (-(-comp // K), -(-comp // K) * K - comp)


def test_batched_pairs_equal_single_ones():
    pairs = traffic.pairs(11, traffic.WINDOW, 5, TINY)
    many = dp.solve_many(COSTS, pairs, no_ts=True)
    assert many == [dp.solve(COSTS, r, q, no_ts=True) for r, q in pairs]


def test_pricer_rejects_altered_alignments():
    al, cfg, Oracle = oracle_parts()
    ref, qry = traffic.twin(traffic.stream(2, traffic.WINDOW), TINY)
    cost, alignment = Oracle(cfg, al.encode(ref), al.encode(qry)).align()
    ops = plain(alignment)
    assert pricer.price(COSTS, ref, qry, ops)[0] == cost
    k = next(i for i, (_, op) in enumerate(ops) if op == "PrimaryMatch")
    n, _ = ops[k]
    relabelled = ops[:k] + [(n, "PrimarySubstitution")] + ops[k + 1:]
    with pytest.raises(pricer.Invalid):
        pricer.price(COSTS, ref, qry, relabelled)
    with pytest.raises(pricer.Invalid):
        pricer.price(COSTS, ref, qry, ops[:-1] + [(ops[-1][0] + 1, ops[-1][1])])
    with pytest.raises(pricer.Invalid):
        pricer.price(COSTS, ref, qry + "A", ops)


def test_reference_reads_nothing_of_the_program():
    import ast

    for name in ("dp.py", "model.py", "pricer.py", "__init__.py"):
        with open(os.path.join(cells.BENCH_DIR, "reference", name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            for m in mods:
                assert m.split(".")[0] in ("torch", "numpy", "__future__"), (name, m)


def test_entrance_costs_of_a_forward_same_sequence_switch():
    import torch

    m = dp.Model(COSTS)
    E = dp.entrance_costs(m, 0, 0, 0, 12, torch.device("cpu"))
    # rr_qq offsets are finite on [-100, 0]: forward offset +1 is the
    # entrance itself (no walk), +2 is not allowed, negative ones walk down
    assert int(E[3, 4]) == m.base_cost(0, 0, 0)
    assert int(E[3, 5]) >= dp.INF
    assert int(E[3, 0]) == m.base_cost(0, 0, 0)
    assert (E[:, 12 - m.min_length + 1:] >= dp.INF).all()
