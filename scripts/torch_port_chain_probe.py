#!/usr/bin/env python3
"""Where chained mode's time goes on the card, at growing sizes.

    python3 scripts/torch_port_chain_probe.py [--sizes 30000 100000 230000]
        [--timeout 900] [--device cuda] [--target-segment 1024]

Aligns the seeded construction of scripts/validate_chain_scale.py
(``chip_smoke.chain_construction``, seed 230147) under its narrow
configuration with ``tsalign_tpu_torch.chain_align(..., device=...)``, one
size a process with a time limit each, and prints one JSON line a size: the
wall split into anchoring, chaining, the batched engine's traceback segments
and cost-only probes, the per-segment engine and what the verification
pass's own logic takes (``chip_smoke.ChainMeter``); the batches by mode,
bucket and pair count with their rounds; segments, anchors, whether the
anchors came from the native kernel, rejoined cuts; the kernels' launches and
device milliseconds by CUDA events (``_build.kernel_events``) and their share
of the wall; and whether the cost equals the constructed optimum and the
alignment reprices to it.  The first line is the card's name and power limit.
Imports only torch and the port.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_one(n: int, device: str, target_segment: int) -> dict:
    sys.path.insert(0, ROOT)
    import torch

    import tsalign_tpu_torch
    from chip_smoke import ChainMeter, chain_config, chain_construction
    from tsalign_tpu_torch import _build
    from tsalign_tpu_torch.alignment import is_template_switch_entrance
    from tsalign_tpu_torch.pricing import price_alignment

    cfg = chain_config()
    ref, qry, expected, n_ts = chain_construction(n)
    if device == "cuda":
        _build.library()  # build (or load) the kernels before the clock starts
        _build.kernel_events = []
    _build.launches.clear()
    with ChainMeter() as meter:
        t0 = time.monotonic()
        res = tsalign_tpu_torch.chain_align(cfg, ref, qry, target_segment=target_segment,
                                            device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.monotonic() - t0
    kernel_ms = _build.kernel_ms() if device == "cuda" else {}
    entrances = sum(1 for _, t in res.alignment.entries if is_template_switch_entrance(t))
    return dict(
        n=n, device=device, cost=res.cost, expected=expected,
        repriced=price_alignment(cfg, ref, qry, res.alignment) == res.cost,
        template_switches=entrances, planted=n_ts, segments=res.segments,
        anchors=res.anchors, anchors_native=res.anchors_native,
        cuts_rejoined=res.cuts_rejoined, numpy_fallbacks=res.numpy_fallbacks,
        launches=dict(_build.launches), kernel_device_ms=kernel_ms,
        kernel_device_share=sum(kernel_ms.values()) / 1e3 / wall,
        **meter.summary(wall))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="+", default=[30000, 100000, 230000])
    ap.add_argument("--timeout", type=int, default=900, help="seconds for each size")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--target-segment", type=int, default=1024)
    ap.add_argument("--one", type=int, help=argparse.SUPPRESS)  # a size in this process
    args = ap.parse_args()
    if args.one:
        print(json.dumps(run_one(args.one, args.device, args.target_segment)), flush=True)
        return
    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip(), flush=True)
    for n in args.sizes:
        cmd = [sys.executable, os.path.abspath(__file__), "--one", str(n), "--device",
               args.device, "--target-segment", str(args.target_segment)]
        t0 = time.monotonic()
        try:
            out = subprocess.run(cmd, capture_output=True, text=True, timeout=args.timeout)
        except subprocess.TimeoutExpired:
            print(json.dumps(dict(n=n, timed_out_after_s=args.timeout)), flush=True)
            continue
        lines = out.stdout.strip().splitlines()
        if out.returncode != 0 or not lines:
            print(json.dumps(dict(n=n, rc=out.returncode, stderr=out.stderr[-3000:])), flush=True)
            continue
        print(lines[-1], flush=True)
        print(json.dumps(dict(n=n, process_s=time.monotonic() - t0)), flush=True)


if __name__ == "__main__":
    main()
