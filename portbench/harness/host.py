"""The host side of a run: thread settings, which have to be made before torch
is imported, and the record of the machine beside each window (CPU count and
affinity, the card's name and power limit, its clocks and power sampled by
nvidia-smi while the window runs).  The record only explains spreads; no
metric is read from it."""

from __future__ import annotations

import os
import subprocess
import time

THREAD_ENV = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def set_thread_env(threads: dict) -> None:
    """The configuration's thread counts for OpenMP, MKL and OpenBLAS; call
    before torch or numpy is imported."""
    for k in THREAD_ENV:
        if k in threads:
            os.environ[k] = str(threads[k])


def set_torch_threads(threads: dict) -> None:
    import torch

    if "torch_intra_op" in threads:
        torch.set_num_threads(int(threads["torch_intra_op"]))


def record(threads: dict) -> dict:
    import torch

    out = {
        "cpu_count": os.cpu_count(),
        "cpu_affinity": sorted(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else None,
        "torch_threads": torch.get_num_threads(),
        "thread_env": {k: os.environ.get(k) for k in THREAD_ENV},
        "threads_asked": threads,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    if torch.cuda.is_available():
        out["card"] = torch.cuda.get_device_name(0)
        out["nvidia_smi"] = _query("name,power.limit,clocks.max.sm")
    return out


def _query(fields: str):
    try:
        res = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return res.stdout.strip().splitlines()


class Sampler:
    """nvidia-smi sampling the card every 500 ms while the window runs."""

    FIELDS = "clocks.sm,clocks.mem,power.draw,temperature.gpu"

    def __init__(self):
        self.proc = None
        self.t0 = None

    def start(self) -> None:
        self.t0 = time.monotonic()
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={self.FIELDS}", "--format=csv,noheader,nounits",
                 "-lms", "500"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self.proc = None

    def stop(self) -> dict:
        if self.proc is None:
            return {"samples": 0}
        self.proc.terminate()
        try:
            out = self.proc.communicate(timeout=20)[0]
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out = self.proc.communicate()[0]
        rows = []
        for line in out.strip().splitlines():
            try:
                rows.append([float(x) for x in line.split(",")])
            except ValueError:
                continue
        rows = [r for r in rows if len(r) == 4]
        if not rows:
            return {"samples": 0}

        def spread(col):
            v = sorted(r[col] for r in rows)
            return [v[0], v[len(v) // 2], v[-1]]

        return {"samples": len(rows), "sm_mhz_min_med_max": spread(0),
                "mem_mhz_min_med_max": spread(1), "power_w_min_med_max": spread(2),
                "temp_c_min_med_max": spread(3)}
