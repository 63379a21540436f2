"""tsalign-tpu-torch: the PyTorch/CUDA port of the tsalign-tpu aligner.

The same template-switch alignment as ``tsalign_tpu``, with its device work
in PyTorch and hand-written CUDA kernels for NVIDIA Hopper.  The port shares
the JAX-free host layers of ``tsalign_tpu`` (config, costs, pricing,
traceback search, postprocessing) and never imports JAX.

    >>> import tsalign_tpu_torch
    >>> result = tsalign_tpu_torch.align("ACGT", "ACGT", device="cuda")
    >>> result.cigar()
"""

__version__ = "0.1.0"

__all__ = ["align", "Aligner"]


def __getattr__(name):
    # Lazy imports keep `import tsalign_tpu_torch` cheap.
    if name in ("align", "Aligner"):
        from . import aligner

        return getattr(aligner, name)
    raise AttributeError(f"module 'tsalign_tpu_torch' has no attribute {name!r}")
