"""Config digest (the port's copy of ``tsalign_tpu/chain/plan.py::config_digest``;
the rest of the chain planner is not ported yet)."""

from __future__ import annotations

import hashlib

from .config import TemplateSwitchConfig


def config_digest(config: TemplateSwitchConfig) -> str:
    """sha1 over the config's canonical display serialization (counterpart
    of sha1(bincode(costs)), util.rs:53-58)."""
    return hashlib.sha1(config.display().encode()).hexdigest()
