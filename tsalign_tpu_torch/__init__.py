"""tsalign-tpu-torch: the PyTorch/CUDA port of the tsalign-tpu aligner.

The same template-switch alignment as ``tsalign_tpu``, with its device work
in PyTorch and hand-written CUDA kernels for NVIDIA Hopper.  The port is a
package of its own: it keeps its own copy of every host layer it uses
(alphabet, config, costs, pricing, the numpy engine, traceback search,
postprocessing, oracle) and imports neither ``tsalign_tpu`` nor JAX.

    >>> import tsalign_tpu_torch
    >>> result = tsalign_tpu_torch.align("ACGT", "ACGT", device="cuda")
    >>> result.cigar()
    >>> records = tsalign_tpu_torch.align_pairs(config, [("ACGT", "ACGA")], device="cuda")
    >>> chained = tsalign_tpu_torch.chain_align(config, ref_codes, qry_codes, device="cuda")
"""

__version__ = "0.1.0"

__all__ = ["align", "Aligner", "align_pairs", "chain_align"]


def __getattr__(name):
    # Lazy imports keep `import tsalign_tpu_torch` cheap.
    if name in ("align", "Aligner"):
        from . import aligner

        return getattr(aligner, name)
    if name == "align_pairs":
        from .parallel import batch_ts

        return batch_ts.align_pairs
    if name == "chain_align":
        from .chain import driver

        return driver.chain_align
    raise AttributeError(f"module 'tsalign_tpu_torch' has no attribute {name!r}")
