"""NaN/Inf and index guards of the engine (``EngineConfig.debug_checks``).

Port of ``fastkv_tpu.utils.guards``. The JAX package instruments its jitted
programs with checkify, which raises at the first NaN/Inf-producing op or
out-of-bounds index; eager PyTorch raises on neither (an out-of-bounds gather
on the card is a device-side assert that ends the process). Here the engine
checks at each layer boundary of prefill and decode (the hidden states and
q/k/v after each layer's projections, the logits) and each gather's indices
before the gather, and raises an error that names the layer.

``Engine.generate`` turns the checks on for its call with ``checking``. Off,
each check is one test of a module flag: nothing is read from the card. On,
decode runs eagerly (``enabled``; ``engine.decode.graphable``).
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch

_on = False
_where = "embedding"


@contextlib.contextmanager
def checking(on: bool = True) -> Iterator[None]:
    """Run the enclosed engine calls with the checks on (or off)."""
    global _on, _where
    prev = _on
    _on, _where = on, "embedding"
    try:
        yield
    finally:
        _on = prev


def enabled() -> bool:
    """Whether the checks are on (they read the card, so a decode step
    that runs them cannot be captured as a CUDA graph)."""
    return _on


def at(where: str) -> None:
    """Mark the layer the next checks belong to (e.g. "prefill layer 3")."""
    global _where
    if _on:
        _where = where


def finite(what: str, *tensors: torch.Tensor) -> None:
    """Raise FloatingPointError if any of ``tensors`` holds a NaN or an Inf."""
    if not _on:
        return
    for t in tensors:
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            raise FloatingPointError(f"{what} at {_where}: NaN or Inf")


def in_bounds(what: str, idx: torch.Tensor, size: int) -> None:
    """Raise IndexError if an index of ``idx`` lies outside [0, size)."""
    if not _on or idx.numel() == 0:
        return
    lo, hi = int(idx.min()), int(idx.max())
    if lo < 0 or hi >= size:
        raise IndexError(f"{what} at {_where}: index range [{lo}, {hi}] outside [0, {size})")
