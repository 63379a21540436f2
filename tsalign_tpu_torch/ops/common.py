"""The int32 saturating (min,+) algebra on torch tensors.

Counterpart of ``tsalign_tpu/ops/jaxcommon.py``.  Host costs (exact Python
ints with INF = 2^62) are clamped to DEV_INF = 2^30 - 1; any device value
>= DEV_INF_THRESH counts as infinite.  One addition of two values <= DEV_INF
cannot overflow int32, and every addition is clamped back to DEV_INF at
once, in the same order as the JAX package.

Gap chains ``D[t] = min(cand[t], D[t-1] + ext[t])`` (clamped after every
add) have the closed form ``D[t] = min_k min(cand[k] + sum(ext[k+1..t]),
DEV_INF)`` whenever ``ext >= 0``.  `minplus_scan` evaluates that form by
log-doubling with the extension sums kept exact in int64, so it equals the
serial recurrence bit for bit on any input with ``ext >= 0``; on the CPU,
over many chains side by side, it runs the serial recurrence itself (in
int64), which does less work there.  The CUDA kernels run the serial
recurrence.  The JAX package clamps the extension
sums inside its scan tree; that tree gives the same values wherever the
candidates are >= 0, which holds under every configuration whose TSM base
costs outweigh the tie-break bonus (the default one included).
"""

from __future__ import annotations

import numpy as np
import torch

from ..costs import INF

DEV_INF = 2**30 - 1
DEV_INF_THRESH = 2**29
I32 = torch.int32


def to_device_costs(x) -> np.ndarray:
    """Clamp host int64 costs (INF = 2^62) into the int32 device algebra."""
    x = np.asarray(x, dtype=np.int64)
    return np.minimum(x, DEV_INF).astype(np.int32)


def from_device_costs(x) -> np.ndarray:
    """Map device int32 costs back to host int64 with INF restored."""
    x = np.asarray(x, dtype=np.int64)
    return np.where(x >= DEV_INF_THRESH, INF, x)


def validate_magnitudes(max_finite_cost: int, path_length: int) -> None:
    """Raise OverflowError when a finite path cost could leave the exact
    int32 range (every finite cost must stay below DEV_INF_THRESH)."""
    if max_finite_cost * max(path_length, 1) >= DEV_INF_THRESH:
        raise OverflowError(
            f"cost magnitudes too large for the int32 device algebra: "
            f"{max_finite_cost} * {path_length} >= {DEV_INF_THRESH}"
        )


def dead_state_threshold(lut, sdo, pmask, io, ie, L: int, *, allow_sdel: bool) -> int:
    """The least state minimum from which a problem of the module scan can
    never come back below DEV_INF_THRESH within L levels, or 0 when there is
    no such value <= DEV_INF (then the kernel must not skip).

    One level moves a value through at most one step cost (a LUT entry, io
    or ie, each with the level's mask added) and, with secondary deletions,
    one open cost sdo and chain extensions sde >= 0; every add is clamped
    from above only.  So a level lowers the state's minimum by at most
    ``drop = max(0, -(min(lut, io, ie) + min(pmask, 0))) + max(0, -min(sdo))``,
    and a state >= DEV_INF_THRESH + (L + 1) * drop stays >= DEV_INF_THRESH
    through every later level.  The arguments are the kind's whole tables
    (numpy arrays or tensors of any shape; io and ie per level or per
    primary char): the bound holds for every chunk."""
    def lo(x):
        x = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
        return int(x.min()) if x.size else 0

    step = min(lo(lut), lo(io), lo(ie)) + min(lo(pmask), 0)
    drop = max(0, -step) + (max(0, -lo(sdo)) if allow_sdel else 0)
    skip_from = DEV_INF_THRESH + (L + 1) * drop
    return skip_from if skip_from <= DEV_INF else 0


def equal_mod_inf(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Whether `got` equals `want` up to the infinite band: equal wherever
    `want` is below DEV_INF_THRESH, and >= DEV_INF_THRESH wherever `want` is."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    finite = want < DEV_INF_THRESH
    return bool(torch.all(torch.where(finite, got == want, got >= DEV_INF_THRESH)))


def full_inf(shape, device) -> torch.Tensor:
    return torch.full(shape, DEV_INF, dtype=I32, device=device)


def sat_add(a, b):
    return torch.clamp_max(a + b, DEV_INF)


def sat_add3(a, b, c):
    return torch.clamp_max(torch.clamp_max(a + b, DEV_INF) + c, DEV_INF)


def _shift_fill(x: torch.Tensor, k: int, fill) -> torch.Tensor:
    """y[..., t] = x[..., t - k] along the last axis, `fill` below k."""
    y = torch.full_like(x, fill)
    if k < x.shape[-1]:
        y[..., k:] = x[..., : x.shape[-1] - k]
    return y


def shift_last(x: torch.Tensor, k: int, fwd: bool) -> torch.Tensor:
    """Shift along the last axis by k, filling with DEV_INF: toward higher
    indices when fwd, toward lower ones otherwise."""
    if fwd:
        return _shift_fill(x, k, DEV_INF)
    y = torch.full_like(x, DEV_INF)
    if k < x.shape[-1]:
        y[..., : x.shape[-1] - k] = x[..., k:]
    return y


def device_key(device) -> str:
    """The one name of a device for the per-device caches: "cuda" and
    "cuda:0" (the current card) name the same card."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return str(d)


def check_extension(name: str, ext: torch.Tensor) -> None:
    """Raise unless every chain extension cost in `ext` is >= 0 (one host
    wait on a device tensor)."""
    if ext.numel() and int(ext.min()) < 0:
        raise ValueError(f"{name}: chain extension costs must be >= 0")


def minplus_scan(cand: torch.Tensor, ext: torch.Tensor, dim: int = -1,
                 reverse: bool = False) -> torch.Tensor:
    """Solve D[t] = min(cand[t], min(D[t-1] + ext[t], DEV_INF)) along `dim`.

    ext[t] is the cost of the chain edge into t (from t+1 with reverse=True)
    and must be >= 0: callers check it once with `check_extension`, so the
    scan itself never waits on the device.  Log-doubling in the form of the
    Pallas module kernel's chain, with the extension sums exact in int64
    (see the module docstring for why that equals the serial recurrence)."""
    cand, ext = torch.broadcast_tensors(cand, ext)
    n = cand.shape[dim]
    if cand.device.type == "cpu" and cand.numel() >= SERIAL_CHAINS * n > 0:
        return _minplus_serial(cand, ext, dim, reverse)
    c = cand.movedim(dim, -1).to(torch.int64)
    e = ext.movedim(dim, -1).to(torch.int64)
    if reverse:
        c, e = c.flip(-1), e.flip(-1)
    shift = 1
    while shift < n:
        c_prev = _shift_fill(c, shift, DEV_INF)
        e_prev = _shift_fill(e, shift, DEV_INF)
        c = torch.minimum(c, torch.clamp_max(c_prev + e, DEV_INF))
        e = e_prev + e
        shift *= 2
    if reverse:
        c = c.flip(-1)
    return c.to(I32).movedim(-1, dim)


# Chains side by side from which `minplus_scan` takes the serial form on the
# CPU: a step of it then moves about as much as a log-doubling step, and
# there are log2(n) times less data in all (about 4-8 times faster on the
# module scan's shapes).  On a card each step is a launch, and the
# log-doubling form's log2(n) steps win.
SERIAL_CHAINS = 512


def _minplus_serial(cand, ext, dim: int, reverse: bool) -> torch.Tensor:
    """`minplus_scan` as the serial recurrence, one step a position (from
    the last position down when `reverse`)."""
    c = cand.movedim(dim, 0).to(torch.int64, memory_format=torch.contiguous_format).numpy()
    e = ext.movedim(dim, 0).to(torch.int64, memory_format=torch.contiguous_format).numpy()
    n = c.shape[0]
    order = range(n - 1, -1, -1) if reverse else range(n)
    # numpy in place: a step is three small ops, each cheaper than a torch op
    out = np.empty_like(c)
    step = np.empty_like(c[0])
    d = None
    for t in order:
        if d is None:
            out[t] = c[t]
        else:
            np.add(d, e[t], out=step)
            np.minimum(step, DEV_INF, out=step)
            np.minimum(c[t], step, out=out[t])
        d = out[t]
    return torch.from_numpy(out).movedim(0, dim).to(I32, memory_format=torch.contiguous_format)


def cummin(x: torch.Tensor, dim: int = -1, reverse: bool = False) -> torch.Tensor:
    if reverse:
        return torch.cummin(x.flip(dim), dim).values.flip(dim)
    return torch.cummin(x, dim).values


def sliding_min_start(x: torch.Tensor, w: int, dim: int = -1) -> torch.Tensor:
    """y[t] = min(x[t], ..., x[t + w - 1]) along `dim` (same length; windows
    running off the end see DEV_INF)."""
    if w <= 1:
        return x
    xm = x.movedim(dim, -1)
    pad = torch.full(xm.shape[:-1] + (w - 1,), DEV_INF, dtype=x.dtype,
                     device=x.device)
    y = torch.cat([xm, pad], dim=-1).unfold(-1, w, 1).amin(dim=-1)
    return y.movedim(-1, dim)


def check_tensor(name, t, shape, device):
    """Raise unless t is a contiguous int32 tensor of `shape` on `device`."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.dtype != I32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
