"""Aligner facade of the port.

`Aligner` subclasses the JAX package's facade (``tsalign_tpu.aligner.Aligner``)
and keeps everything above the engine: the settings, the K-scaled
maximise-TS-length tie-break (``Aligner._run_engine``), postprocessing and the
TOML record.  It overrides only ``_run_engine_raw`` to run the port's
``engine.TorchAligner`` on its `device`, whatever the sequence length.  An
``OverflowError`` from the int32 algebra is raised, not sent to the numpy
engine: that engine reaches JAX at run time.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

from tsalign_tpu import aligner as _base
from tsalign_tpu.alignment import Alignment

from .engine import TorchAligner


@dataclass
class Aligner(_base.Aligner):
    """Configurable aligner facade on a torch device ("cuda", "cpu", ...)."""

    device: Optional[str] = None

    def __post_init__(self):
        super().__post_init__()
        if self.device is None:
            raise ValueError("Aligner needs an explicit device, e.g. device='cuda'")

    def _run_engine_raw(self, cfg, ref_arr, qry_arr, range_, max_ts,
                        allowed_primaries, prune_range: bool) -> Tuple[int, Alignment]:
        eng = TorchAligner(
            cfg, ref_arr, qry_arr,
            device=self.device,
            range_=range_,
            max_template_switches=max_ts,
            prune_range=prune_range,
            allowed_primaries=allowed_primaries,
            chunk=self.chunk,
        )
        out = eng.align_with_traceback()
        self._last_cells = getattr(self, "_last_cells", 0) + eng.cells_swept
        self._last_rounds = getattr(eng, "last_rounds", 1)
        return out


def align(reference: str, query: str, costs: Optional[str] = None,
          alphabet: str = "dna-n", *, device: str, **kwargs) -> _base.TSPairwiseAlignment:
    """Module-level convenience (``tsalign_tpu.aligner.align`` on `device`).

    Keyword arguments naming Aligner settings configure the aligner; the
    rest (range_, cost_limit, max_template_switches, ...) go to align()."""
    setting_names = {f.name for f in dataclasses.fields(Aligner)}
    settings = {k: v for k, v in kwargs.items() if k in setting_names}
    call_kwargs = {k: v for k, v in kwargs.items() if k not in setting_names}
    a = Aligner(alphabet=alphabet, device=device, **settings)
    if costs is not None:
        a.set_costs_parse(costs)
    return a.align(reference, query, **call_kwargs)
