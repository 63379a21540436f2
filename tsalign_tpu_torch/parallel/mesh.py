"""A single-process device mesh and the collectives of the mesh paths.

The port's counterpart of ``jax.sharding.Mesh`` as the JAX package's mesh
modules use it (``parallel/batch.py``, ``sp_sweep.py``, ``sp_reentry.py``
and the batched engine's ``mesh=`` path): a 1-D tuple of devices under one
axis name.  The JAX code is single-controller (``shard_map`` inside one
``jit``), so this mesh is too: one process holds a list of per-shard
tensors and runs each shard's work on its device in turn.  Devices may
repeat: ``Mesh(["cuda:0"] * 4, ("sp",))`` is four shards on one card, and
``Mesh([f"cuda:{i}" for i in range(n)], ("data",))`` one shard a card.

The collectives are plain functions over a list of per-shard tensors, in
shard order, each returning one tensor a shard; every move between shards
is an explicit ``.to(device)`` (no copy where both shards share a device):

  * `ppermute_right`: the permutation ``[(d, d + 1)]``; shard 0 receives
    DEV_INF (``lax.ppermute`` as ``sp_sweep.py`` uses it);
  * `all_gather`: every shard's tensor stacked in shard order on each shard;
  * `pmin`: the elementwise minimum over the shards, on each shard;
  * `pmean`: the float32 mean of every shard's elements, on each shard (the
    batch mean of ``BatchedGapAffine.sharded_step``).

`shard_blocks` splits a leading axis in contiguous equal blocks over a mesh
axis, as ``PartitionSpec(axis, ...)`` does, and raises ``ValueError`` where
the axis does not divide it, as ``jax.device_put`` does.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..ops.common import DEV_INF


class Mesh:
    """Devices in shard order under one axis name; ``shape[axis]`` is the
    shard count."""

    def __init__(self, devices: Sequence, axis_names: Sequence[str] = ("data",)):
        if len(axis_names) != 1:
            raise ValueError(f"a Mesh has one axis, got the names {tuple(axis_names)}")
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("a Mesh needs at least one device")
        for d in devs:
            _check_present(d)
        self.devices = devs
        self.axis_names = (str(axis_names[0]),)
        self.shape = {self.axis_names[0]: len(devs)}

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]}, {self.axis_names})"


def _check_present(d: torch.device) -> None:
    """Raise unless the device exists in this process (never falls back)."""
    if d.type == "cpu":
        return
    if d.type != "cuda":
        raise ValueError(f"a Mesh takes cpu or cuda devices, not {d}")
    if not torch.cuda.is_available():
        raise ValueError(f"the Mesh names {d}, but no CUDA device is present")
    n = torch.cuda.device_count()
    if d.index is not None and d.index >= n:
        raise ValueError(f"the Mesh names {d}, but only {n} CUDA device(s) are present")


def axis_size(mesh: Mesh, axis: str) -> int:
    if axis not in mesh.shape:
        raise ValueError(f"{mesh} has no axis {axis!r}")
    return mesh.shape[axis]


def shard_blocks(mesh: Mesh, n: int, axis: str) -> List[Tuple[slice, torch.device]]:
    """[(slice, device)] of each shard of an axis of length n split in
    contiguous equal blocks over ``mesh[axis]``."""
    D = axis_size(mesh, axis)
    if n % D:
        raise ValueError(
            f"an axis of length {n} does not split over the {D} shards of mesh axis "
            f"{axis!r}: the shard count must divide it")
    per = n // D
    return [(slice(d * per, (d + 1) * per), dev) for d, dev in enumerate(mesh.devices)]


def ppermute_right(xs: List[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """Shard d receives shard d - 1's tensor; shard 0 receives DEV_INF."""
    out = [torch.full_like(xs[0], DEV_INF)]
    for x, dev in zip(xs[:-1], mesh.devices[1:]):
        out.append(x.to(dev))
    return out


def all_gather(xs: List[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """Each shard gets every shard's tensor, stacked in shard order."""
    out, held = [], {}
    for dev in mesh.devices:
        key = str(dev)
        if key not in held:
            held[key] = torch.stack([x.to(dev) for x in xs])
        out.append(held[key])
    return out


def replicate(x: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """`x` on every shard's device."""
    return [x.to(dev) for dev in mesh.devices]


def pmin(xs: List[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """The elementwise minimum of the shards' tensors, on every shard."""
    dev0 = mesh.devices[0]
    m = xs[0].to(dev0)
    for x in xs[1:]:
        m = torch.minimum(m, x.to(dev0))
    return replicate(m, mesh)


def pmean(xs: List[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """The float32 mean of all the shards' elements, on every shard: each
    shard's float32 sum, summed across the shards, over the element count."""
    dev0 = mesh.devices[0]
    total = sum(x.to(torch.float32).sum().to(dev0) for x in xs)
    count = sum(x.numel() for x in xs)
    return replicate(total / count, mesh)
