"""Carry state across: host tables to torch tensors, and the JAX package's
config objects to the port's.

The system has no weights; its state is the per-kind and per-sweep tables
and the cost configuration.  `config_from_reference` and
`range_from_reference` rebuild a ``tsalign_tpu`` config or range as the
port's own class, reading it by attribute so that nothing of that package is
imported.  `tables_from_numpy` turns a dict of numpy arrays (the port's own
``KindModule.host_tables()``, or ``np.asarray`` of each entry of the JAX
package's ``JaxKindModule._fixed`` or ``JaxPrimarySweep.flankless_inputs()``)
into int32 tensors on a device, so that tests can feed the JAX functions and
the port identical tables.
"""

from __future__ import annotations

import numpy as np

from .ops.common import to_device


def tables_from_numpy(d: dict, device) -> dict:
    """{name: numpy array} -> {name: contiguous int32 tensor on device}."""
    out = {}
    for name, arr in d.items():
        a = np.ascontiguousarray(np.asarray(arr))
        if a.dtype != np.int32:
            if a.size and (a.min() < np.iinfo(np.int32).min or a.max() > np.iinfo(np.int32).max):
                raise ValueError(f"table {name!r} does not fit int32")
            a = a.astype(np.int32)
        out[name] = to_device(a, device)
    return out


def _alphabet_from_reference(al):
    from .alphabet import Alphabet

    return Alphabet(name=al.name, letters=al.letters, complement=tuple(al.complement))


def _table_from_reference(t, alphabet):
    from .costs import GapAffineCostTable

    return GapAffineCostTable(
        name=t.name,
        alphabet=alphabet,
        substitution=np.array(t.substitution, dtype=np.int64),
        gap_open=np.array(t.gap_open, dtype=np.int64),
        gap_extend=np.array(t.gap_extend, dtype=np.int64),
    )


def config_from_reference(cfg):
    """The port's ``TemplateSwitchConfig`` with the contents of a config
    object of the JAX package.  `cfg` is read by attribute only (alphabet
    name / letters / complement, flank lengths, base costs, the five cost
    tables as arrays, the six cost functions as their points, the length
    bonus), so nothing of that package is imported here."""
    from .config import TemplateSwitchConfig
    from .costs import CostFunction

    alphabet = _alphabet_from_reference(cfg.alphabet)
    tables = {
        name: _table_from_reference(getattr(cfg, name), alphabet)
        for name in (
            "primary_edit_costs",
            "secondary_forward_edit_costs",
            "secondary_reverse_edit_costs",
            "left_flank_edit_costs",
            "right_flank_edit_costs",
        )
    }
    functions = {
        name: CostFunction([(int(x), int(c)) for x, c in getattr(cfg, name).points])
        for name in (
            "rq_qr_offset_costs",
            "rr_qq_offset_costs",
            "length_costs",
            "length_difference_costs",
            "forward_anti_primary_gap_costs",
            "reverse_anti_primary_gap_costs",
        )
    }
    return TemplateSwitchConfig(
        alphabet=alphabet,
        left_flank_length=int(cfg.left_flank_length),
        right_flank_length=int(cfg.right_flank_length),
        base_cost={k: int(v) for k, v in cfg.base_cost.items()},
        secondary_length_bonus=int(cfg.secondary_length_bonus),
        **tables,
        **functions,
    )


def range_from_reference(r):
    """The port's ``AlignmentRange`` with the bounds of a range object of the
    JAX package (None stays None)."""
    from .geometry import AlignmentRange

    if r is None:
        return None
    return AlignmentRange(
        int(r.reference_offset), int(r.query_offset),
        int(r.reference_limit), int(r.query_limit),
    )
