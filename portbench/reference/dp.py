"""The optimum of a template-switch alignment by a dense dynamic programme.

A plain PyTorch restatement of upstream's search graph (lib_tsalign
template_switch_distance/context.rs:125-761), written for this benchmark and
sharing no code with the program under test:

* the primary alignment is gap-affine over (reference, query) cells with the
  states none, insertion (query consumed) and deletion (reference consumed);
* a template switch leaves any primary cell (i, j), pays its base cost and
  the offset walk to a secondary start s0, aligns the next primary bases
  against the secondary sequence from s0 (forward, or reverse-complemented
  backward) under the secondary table, exits after `length` primary bases
  (the length cost), walks the length difference D (its cost), and re-enters
  the primary at the anti index plus length + D (the anti-primary gap cost);
* rounds: V_0 is the primary field from the root, and V_k the primary field
  from the root and every re-entry that V_{k-1} reaches, until V stops
  changing (each template switch costs more than nothing, so it does).

The secondary alignments depend on the sequences only, so each of the eight
kinds is aligned once for every entry and start; a round then takes, for
every re-entry cell, the least entry value plus the switch's cost, with the
window minima over the anti axis read from a sparse table.  Everything is
int32: finite values stay below 2^28 at the sizes benchmarked, every sum is
taken back to INF from 2^28 on.
"""

from __future__ import annotations

import torch

from .model import INF, THRESH, Model, complement_code, encode

I32 = torch.int32
MAX_ROUNDS = 32
TS_SCALE = 1 << 16  # K of the tie-break: above any total template-switch length here


def _inf(x: torch.Tensor) -> torch.Tensor:
    return x.masked_fill_(x >= THRESH, INF)


def _full(shape, device, value=INF):
    return torch.full(shape, value, dtype=I32, device=device)


def _gap_scan(X: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
    """G[..., w] = min over k < w of X[..., k] + steps[w - 1] - steps[k]
    (a gap opened at k, with X holding the opening's cost, extended to w),
    INF at w = 0.  `steps` is the running sum of the extension costs."""
    out = torch.full_like(X, INF)
    run = torch.cummin(X - steps, dim=-1).values
    out[..., 1:] = run[..., :-1] + steps[:-1]
    return _inf(out)


def primary(m: Model, R: torch.Tensor, Q: torch.Tensor, seeds: torch.Tensor) -> torch.Tensor:
    """V (B, n_r+1, n_q+1): the least cost of each primary cell over its
    three states, from `seeds` (values of the none state), for a batch of B
    pairs of one shape (R (B, n_r), Q (B, n_q))."""
    n_r, n_q = R.shape[1], Q.shape[1]
    t = m.primary
    dev = seeds.device
    steps = torch.arange(n_q + 1, device=dev, dtype=I32) * t.ext
    V = torch.full_like(seeds, INF)

    def insertions(N, D):
        opened = torch.full_like(N, INF)
        opened[:, 1:] = _inf(torch.minimum(N[:, :-1], D[:, :-1]) + t.open)
        # I[j] = min(I[j-1] + ext, opened[j]): a scan with the open at j itself
        return _inf(torch.cummin(opened - steps, dim=1).values + steps)

    N = seeds[:, 0].clone()
    D = torch.full_like(N, INF)
    I = insertions(N, D)
    V[:, 0] = torch.minimum(torch.minimum(N, D), I)
    for i in range(1, n_r + 1):
        sub = torch.where(Q == R[:, i - 1:i], t.match, t.sub).to(I32)
        Nn = seeds[:, i].clone()
        Nn[:, 1:] = torch.minimum(Nn[:, 1:], _inf(V[:, i - 1, :-1] + sub))
        D = _inf(torch.minimum(D + t.ext, torch.minimum(N, I) + t.open))
        N = Nn
        I = insertions(N, D)
        V[:, i] = torch.minimum(torch.minimum(N, D), I)
    return V


def secondary(m: Model, P: torch.Tensor, S: torch.Tensor, dk: int) -> torch.Tensor:
    """G (n_P+1, n_S+1, n_P+1): G[e, s0, l] is the least cost of a
    secondary alignment that starts at primary index e and secondary index
    s0 and has consumed l primary bases, over every secondary end and state."""
    nP, nS = P.numel(), S.numel()
    t = m.secondary[dk]
    dev = P.device
    # The walk coordinate w moves +1 a secondary base in both directions:
    # forward w = s, reverse w = n_S - s reading the complement backwards.
    if dk == 0:
        walk = S
    else:
        comp = torch.tensor([complement_code(c) for c in range(4)], device=dev, dtype=S.dtype)
        walk = comp[S.long()].flip(0)
    steps = torch.arange(nS + 1, device=dev, dtype=I32) * t.ext
    G = _full((nP + 1, nS + 1, nP + 1), dev)
    N = _full((nP + 1, nS + 1, nS + 1), dev)
    N.diagonal(dim1=1, dim2=2).fill_(0)
    I = _full((nP + 1, nS + 1, nS + 1), dev)
    for l in range(nP + 1):
        rows = nP + 1 - l  # entries e with e + l <= n_P
        moves = m.length.min_from(l) < INF  # a switch that can still end may go on
        if moves:
            D = _gap_scan(_inf(torch.minimum(N, I) + t.open), steps)
            best = torch.minimum(torch.minimum(N, D), I)
        else:
            best = torch.minimum(N, I)
        G[:rows, :, l] = best.amin(dim=-1)
        if l == nP or not moves:
            break
        r2 = rows - 1
        pch = P[l:l + r2]  # the next primary base of each live entry
        sub = (torch.where(pch[:, None] == walk[None, :], t.match, t.sub) - m.bonus).to(I32)
        Nn = _full((r2, nS + 1, nS + 1), dev)
        Nn[:, :, 1:] = _inf(best[:r2, :, :-1] + sub[:, None, :])
        I = _inf(torch.minimum(I[:r2] + t.ext, torch.minimum(N[:r2], D[:r2]) + t.open) - m.bonus)
        N = Nn
    return G if dk == 0 else G.flip(1)


def entrance_costs(m: Model, pk: int, sk: int, dk: int, nS: int, dev) -> torch.Tensor:
    """E (n_S+1, n_S+1): E[e_s, s0] is the base cost plus the offset walk
    from the secondary entrance index e_s to the start s0, INF where the
    walk or the start is not allowed (context.rs:357-488)."""
    off = m.offset(pk, sk)
    base = m.base_cost(pk, sk, dk)
    by_F = [INF] * (2 * nS + 1)  # by_F[F + nS]: the cost of ending the walk at offset F
    if base < INF and off(0) < INF:
        finite = {f: off(f) < INF for f in range(-nS, nS + 1)}
        for sign in (1, -1):
            start = sign if dk == 0 else 0
            ok = True
            for F in range(start, sign * (nS + 1), sign):
                ok = ok and finite[F]
                if dk == 0 and abs(F) == 1:
                    by_F[F + nS] = base + off(0)  # the entrance itself, no walk
                elif ok:
                    by_F[F + nS] = base + off(F) + (off(0) - off(sign) if dk == 0 else 0)
    by_F = torch.tensor(by_F, dtype=torch.int64, device=dev).clamp(max=INF).to(I32)
    lo, hi = (0, nS - m.min_length) if dk == 0 else (m.min_length, nS)
    e_s = torch.arange(nS + 1, device=dev)[:, None]
    s0 = torch.arange(nS + 1, device=dev)[None, :]
    E = by_F[s0 - e_s + nS]
    return E.masked_fill_((s0 < lo) | (s0 > hi), INF)


def _pieces(fn, lo: int, hi: int):
    """[(a, b, cost)]: the runs of equal finite cost of `fn` on [lo, hi]."""
    out = []
    x = lo
    while x <= hi:
        c = fn(x)
        y = x
        while y < hi and fn(y + 1) == c:
            y += 1
        if c < INF:
            out.append((x, y, c))
        x = y + 1
    return out


class Kind:
    """One template-switch kind (primary pk, secondary sk, direction dk):
    its secondary alignments reduced over the offset walk, with the base and
    length costs, T[e_p, e_a, l] (e_a ignored for a same-sequence kind)."""

    def __init__(self, m: Model, R, Q, pk: int, sk: int, dk: int):
        self.pk, self.sk, self.dk = pk, sk, dk
        P = R if pk == 0 else Q
        A = Q if pk == 0 else R
        S = R if sk == 0 else Q
        self.nP, self.nA, nS = P.numel(), A.numel(), S.numel()
        dev = R.device
        G = secondary(m, P, S, dk)
        E = entrance_costs(m, pk, sk, dk, nS, dev)
        lengths = torch.tensor([m.length(l) for l in range(self.nP + 1)], device=dev,
                               dtype=torch.int64).clamp(max=INF).to(I32)
        if pk == sk:  # the secondary entrance is the primary entry index
            T = (E[:, :, None] + G).amin(dim=1)[:, None, :]
        else:  # the secondary entrance is the anti index
            T = _full((self.nP + 1, self.nA + 1, self.nP + 1), dev)
            for e0 in range(0, self.nP + 1, 16):
                g = G[e0:e0 + 16]
                T[e0:e0 + 16] = (E[None, :, :, None] + g[:, None, :, :]).amin(dim=2)
        self.T = _inf(_inf(T) + lengths)
        # the length difference: its finite run around 0 and that run's pieces
        run = m.length_difference.finite_run(0, -2 * (self.nP + self.nA), 2 * (self.nP + self.nA))
        self.ld_run = run
        self.ld_pieces = _pieces(m.length_difference, *run) if run else []
        span = self.nA + self.nP + 1
        self.ag_pieces = _pieces(m.anti_gap[dk], -span, span)

    def reentry(self, V: torch.Tensor) -> torch.Tensor:
        """Rk (n_P+1, n_A): the least cost of re-entering the primary at
        (primary p', anti a') by one switch of this kind from the field V."""
        nP, nA = self.nP, self.nA
        dev = V.device
        out = _full((nP + 1, nA), dev)
        if not self.ld_pieces or not self.ag_pieces:
            return out
        Vk = V if self.pk == 0 else V.t()
        W = _inf(Vk[:, :, None] + self.T)  # (e_p, e_a, l)
        p = torch.arange(nP + 1, device=dev)
        l = torch.arange(nP + 1, device=dev)
        e_p = p[:, None] - l[None, :]  # (p', l)
        live = e_p >= 0
        Wp = W[e_p.clamp(min=0), :, l[None, :].expand(nP + 1, -1)]  # (p', l, e_a)
        Wp[~live] = INF
        # sparse table of minima over the anti axis
        levels = [Wp]
        width = 1
        while 2 * width <= nA + 1:
            prev = levels[-1]
            nxt = prev.clone()
            nxt[..., :-width] = torch.minimum(prev[..., :-width], prev[..., width:])
            levels.append(nxt)
            width *= 2
        table = torch.stack(levels)  # (k, p', l, e_a)
        log2 = torch.zeros(nA + 2, dtype=torch.int64, device=dev)
        for n in range(2, nA + 2):
            log2[n] = log2[n // 2] + 1
        a = torch.arange(nA, device=dev)
        wlo, whi = self.ld_run
        d_lo = torch.clamp(-p, min=wlo)  # the walk down stops at anti index 0
        d_hi = torch.clamp(torch.clamp(nA - p, min=0), max=whi)  # up to the anti end
        flat = table.reshape(-1)
        stride_k, stride_p, stride_l = table.stride(0), table.stride(1), table.stride(2)
        base_idx = p[:, None, None] * stride_p + l[None, :, None] * stride_l  # (p', l, 1)
        for d1, d2, c1 in self.ld_pieces:
            lo_d = torch.clamp(d_lo, min=d1)[:, None, None]
            hi_d = torch.clamp(d_hi, max=d2)[:, None, None]
            for g1, g2, c2 in self.ag_pieces:
                g_lo = torch.clamp(lo_d + l[None, :, None], min=g1)
                g_hi = torch.clamp(hi_d + l[None, :, None], max=g2)
                e_lo = torch.clamp(a[None, None, :] - g_hi, min=0)
                e_hi = torch.clamp(a[None, None, :] - g_lo, max=nA)
                ok = (e_lo <= e_hi) & (hi_d >= lo_d) & live[:, :, None]
                n = torch.where(ok, e_hi - e_lo + 1, torch.ones_like(e_hi))
                k = log2[n]
                i1 = base_idx + k * stride_k + torch.where(ok, e_lo, 0)
                i2 = base_idx + k * stride_k + torch.where(ok, e_hi - (torch.ones_like(k) << k) + 1, 0)
                best = torch.minimum(flat[i1], flat[i2])
                best = _inf(best + (c1 + c2))
                best[~ok] = INF
                out = torch.minimum(out, best.amin(dim=1))
        return out


def solve_many(costs: dict, pairs, *, no_ts: bool, device="cpu", K: int = TS_SCALE):
    """[(cost, ts_total_length)] of each (reference, query) pair: the least
    cost under the maximise tie-break, and among the alignments of that cost
    the largest total length of template switches; (None, None) where no
    alignment exists.  Without template switches the pairs of one shape run
    as one batch."""
    m = Model(costs, K)
    dev = torch.device(device)
    out = [None] * len(pairs)
    groups = {}
    for k, (ref, qry) in enumerate(pairs):
        groups.setdefault((len(ref), len(qry)) if no_ts else k, []).append(k)
    for ks in groups.values():
        R = torch.tensor([encode(pairs[k][0]) for k in ks], dtype=I32, device=dev)
        Q = torch.tensor([encode(pairs[k][1]) for k in ks], dtype=I32, device=dev)
        for k, comp in zip(ks, _optimum(m, R, Q, no_ts).tolist()):
            if comp >= INF:
                out[k] = (None, None)
            else:
                cost = -(-comp // K)
                out[k] = (cost, cost * K - comp)
    return out


def solve(costs: dict, reference: str, query: str, *, no_ts: bool, device="cpu",
          K: int = TS_SCALE):
    """(cost, ts_total_length) of one pair (see `solve_many`)."""
    return solve_many(costs, [(reference, query)], no_ts=no_ts, device=device, K=K)[0]


def _optimum(m: Model, R: torch.Tensor, Q: torch.Tensor, no_ts: bool) -> torch.Tensor:
    """The value at the target of each pair of the batch (one pair where
    template switches are allowed)."""
    n_r, n_q = R.shape[1], Q.shape[1]
    root = _full((R.shape[0], n_r + 1, n_q + 1), R.device)
    root[:, 0, 0] = 0
    V = primary(m, R, Q, root)
    if not no_ts:
        if R.shape[0] != 1:
            raise ValueError("template switches: one pair a call")
        kinds = [Kind(m, R[0], Q[0], pk, sk, dk) for pk in (0, 1) for sk in (0, 1)
                 for dk in (0, 1) if m.base_cost(pk, sk, dk) < INF]
        for _ in range(MAX_ROUNDS):
            seeds = root.clone()
            for kd in kinds:
                Rk = kd.reentry(V[0])
                if kd.pk == 0:
                    seeds[0, :, :n_q] = torch.minimum(seeds[0, :, :n_q], Rk)
                else:
                    seeds[0, :n_r, :] = torch.minimum(seeds[0, :n_r, :], Rk.t())
            V_next = primary(m, R, Q, seeds)
            if torch.equal(V_next, V):
                break
            V = V_next
        else:
            raise RuntimeError(f"the reference did not settle in {MAX_ROUNDS} rounds")
    return V[:, n_r, n_q]
