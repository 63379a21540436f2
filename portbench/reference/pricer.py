"""Prices a recorded alignment by walking it over the plain cost model.

The alignment comes as plain tuples, as the harness reads them from a record:
``(count, op)`` with op a string (``"PrimaryMatch"``, ``"SecondaryDeletion"``,
...), ``("TemplateSwitchEntrance", primary, secondary, direction,
first_offset)`` or ``("TemplateSwitchExit", anti_primary_gap)``.  Every step
is checked against the sequences and the search graph of upstream
(context.rs:125-761): a match must match, a substitution must not, no index
may leave its sequence, the offset and length-difference walks must be
allowed, and the walk must end at the end of both sequences outside a
template switch.  Returns ``(cost, ts_total_length)`` or raises ``Invalid``.
"""

from __future__ import annotations

from .model import INF, Model, complement_code, encode


class Invalid(ValueError):
    pass


def walk(fn, start: int, end: int) -> int:
    """The cost of a walk of fn's input from `start` to `end` one step at a
    time, each step to a finite cost: fn(end) - fn(start)."""
    step = 1 if end >= start else -1
    for x in range(start + step, end + step, step):
        if fn(x) >= INF:
            raise Invalid("a walk through an infinite cost")
    return fn(end) - fn(start)


def price(costs: dict, reference: str, query: str, ops) -> tuple:
    m = Model(costs)
    ref, qry = encode(reference), encode(query)
    seqs = (ref, qry)
    i = j = 0
    gap = "none"
    total = 0
    ts_total = 0
    ts = None  # the open template switch: dict of its state

    def add(c):
        nonlocal total
        if c >= INF:
            raise Invalid("an infinitely priced step")
        total += c

    for count, op in ops:
        if isinstance(op, tuple) and op[0] == "TemplateSwitchEntrance":
            if ts is not None:
                raise Invalid("an entrance inside a template switch")
            _, prim, sec, direc, F = op
            pk, sk, dk = ("Reference", "Query").index(prim), ("Reference", "Query").index(sec), \
                ("Forward", "Reverse").index(direc)
            off = m.offset(pk, sk)
            add(m.base_cost(pk, sk, dk))
            add(off(0))
            if dk == 0:
                if F == 0:
                    raise Invalid("a forward switch at offset 0")
                if abs(F) > 1:
                    sign = 1 if F > 0 else -1
                    add(off(sign))
                    total += walk(off, sign, F)
            else:
                total += walk(off, 0, F)
            S = seqs[sk]
            s0 = (i if sk == 0 else j) + F
            lo, hi = (0, len(S) - m.min_length) if dk == 0 else (m.min_length, len(S))
            if not lo <= s0 <= hi:
                raise Invalid(f"a secondary start {s0} outside [{lo}, {hi}]")
            ts = dict(pk=pk, sk=sk, dk=dk, ei=i, ej=j, p=(i if pk == 0 else j), s=s0, length=0)
            gap = "none"
            continue
        if isinstance(op, tuple) and op[0] == "TemplateSwitchExit":
            if ts is None:
                raise Invalid("an exit outside a template switch")
            g = op[1]
            length = ts["length"]
            add(m.length(length))
            D = g - length
            add(m.length_difference(0))
            A_len = len(seqs[1 - ts["pk"]])
            # the walk's position test uses the primary index (context.rs:662-707)
            if (D > 0 and not ts["p"] + D - 1 < A_len) or (D < 0 and not ts["p"] + D + 1 > 0):
                raise Invalid("a length-difference walk out of the anti range")
            total += walk(m.length_difference, 0, D)
            add(m.anti_gap[ts["dk"]](g))
            if ts["pk"] == 0:
                i, j = ts["p"], ts["ej"] + g
                if not 0 <= j < len(qry):
                    raise Invalid("a re-entry outside the query")
            else:
                i, j = ts["ei"] + g, ts["p"]
                if not 0 <= i < len(ref):
                    raise Invalid("a re-entry outside the reference")
            ts_total += length
            ts = None
            gap = "none"
            continue
        if op in ("Root", "SecondaryRoot", "PrimaryReentry"):
            continue
        if not isinstance(op, str) or count < 1:
            raise Invalid(f"an unknown step {op!r} x {count}")
        for _ in range(count):
            if op.startswith("Primary"):
                if ts is not None or op.startswith("PrimaryFlank"):
                    raise Invalid(f"{op} inside a template switch or on a flank")
                t = m.primary
                if op in ("PrimaryMatch", "PrimarySubstitution"):
                    if i >= len(ref) or j >= len(qry):
                        raise Invalid(f"{op} past an end")
                    if (ref[i] == qry[j]) != (op == "PrimaryMatch"):
                        raise Invalid(f"{op} at ({i}, {j}) on bases that do not say so")
                    add(t.match if op == "PrimaryMatch" else t.sub)
                    i, j, gap = i + 1, j + 1, "none"
                elif op == "PrimaryDeletion":
                    if i >= len(ref):
                        raise Invalid("a deletion past the reference's end")
                    add(t.ext if gap == "del" else t.open)
                    i, gap = i + 1, "del"
                elif op == "PrimaryInsertion":
                    if j >= len(qry):
                        raise Invalid("an insertion past the query's end")
                    add(t.ext if gap == "ins" else t.open)
                    j, gap = j + 1, "ins"
                else:
                    raise Invalid(f"an unknown step {op!r}")
                continue
            if ts is None or not op.startswith("Secondary"):
                raise Invalid(f"{op} outside a template switch")
            t = m.secondary[ts["dk"]]
            P, S = seqs[ts["pk"]], seqs[ts["sk"]]
            if ts["dk"] == 0:
                s_char = S[ts["s"]] if 0 <= ts["s"] < len(S) else None
                s_step = 1
            else:
                s_char = complement_code(S[ts["s"] - 1]) if 0 < ts["s"] <= len(S) else None
                s_step = -1
            if m.length.min_from(ts["length"]) >= INF:
                raise Invalid("a secondary step that no exit can follow")
            if op in ("SecondaryMatch", "SecondarySubstitution"):
                if s_char is None or ts["p"] >= len(P):
                    raise Invalid(f"{op} past an end")
                if (P[ts["p"]] == s_char) != (op == "SecondaryMatch"):
                    raise Invalid(f"{op} on bases that do not say so")
                add(t.match if op == "SecondaryMatch" else t.sub)
                ts["p"] += 1
                ts["s"] += s_step
                ts["length"] += 1
                gap = "none"
            elif op == "SecondaryDeletion":
                if s_char is None:
                    raise Invalid("a secondary deletion past an end")
                add(t.ext if gap == "del" else t.open)
                ts["s"] += s_step
                gap = "del"
            elif op == "SecondaryInsertion":
                if ts["p"] >= len(P):
                    raise Invalid("a secondary insertion past the primary's end")
                add(t.ext if gap == "ins" else t.open)
                ts["p"] += 1
                ts["length"] += 1
                gap = "ins"
            else:
                raise Invalid(f"an unknown step {op!r}")
    if ts is not None or (i, j) != (len(ref), len(qry)):
        raise Invalid(f"the alignment ends at ({i}, {j}), not at the ends of both sequences")
    return total, ts_total
