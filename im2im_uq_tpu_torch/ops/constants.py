"""Constant tables of the plain versions, made once per shape on their device.

A CUDA graph's capture may copy nothing from the host, so the tables that
the plain PyTorch versions build from numpy (the upsample's phase weights,
the resize's taps, the softmax head's class bounds) are kept on the device
per key once a shape has been seen. Only plain tensors for plain integer
sizes are kept: under ``torch.export`` or another tracer a table comes out
as a fake or functional tensor, or a size as a symbol, and such a table is
built for that call alone. Tables are made outside inference mode, so that
autograd may save them when the first call ran under it.
"""

from __future__ import annotations

from typing import Callable, Hashable

import torch

__all__ = ["clear", "device_constants"]

_TABLES: dict = {}


def device_constants(key: Hashable, sizes: tuple, build: Callable[[], tuple]) -> tuple:
    """``build()``'s tensors, kept under ``key`` when every one of ``sizes``
    is an ``int`` and every tensor a plain ``torch.Tensor``."""
    keep = all(type(s) is int for s in sizes)
    if keep and key in _TABLES:
        return _TABLES[key]
    with torch.inference_mode(False):
        out = tuple(build())
    if keep and all(type(t) is torch.Tensor for t in out):
        _TABLES[key] = out
    return out


def clear() -> None:
    """Forget every kept table."""
    _TABLES.clear()
