"""The time of a call: CUDA events on the card, the host clock elsewhere."""

from __future__ import annotations

import time
from typing import Callable

import torch

__all__ = ["time_ms"]


def time_ms(fn: Callable, iters: int, device: torch.device = torch.device("cuda")) -> float:
    """Mean time of ``fn`` in ms over ``iters`` calls after two warm-up
    calls: from CUDA events on a CUDA ``device``, from the host clock on
    any other."""
    for _ in range(2):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return 1e3 * (time.perf_counter() - t0) / iters
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters
