"""Timing helpers shared by the port's profiling and benchmark tools."""

from __future__ import annotations

import subprocess
import time


def card_label(device) -> str:
    """"<name>, <power limit>" of a CUDA device as nvidia-smi prints them
    (torch's device name where nvidia-smi cannot be run), or "cpu"."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                              f"--id={index}"], capture_output=True, text=True, timeout=60,
                             check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(index)


def best_ms(fn, device, n_iters: int = 3) -> float:
    """The best of `n_iters` timed calls of fn() in ms, after one warm call:
    CUDA events around each call on a CUDA device (the host's issue time
    included), time.perf_counter on the CPU."""
    import torch

    device = torch.device(device)
    fn()
    best = float("inf")
    for _ in range(n_iters):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, (time.perf_counter() - t0) * 1e3)
    return best
