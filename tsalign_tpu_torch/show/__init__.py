"""Visualization of template-switch alignments (lib_tsshow counterpart)."""
