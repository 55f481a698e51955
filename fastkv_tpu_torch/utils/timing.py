"""Device timing helpers.

Port of ``fastkv_tpu.utils.timing``. A CUDA launch returns before its kernel
ends, so a host-clock time of device work ends with a synchronisation:
``force`` waits for the card and reads one value of a result back.
"""

from __future__ import annotations

import subprocess
import time
from typing import Any

import torch


def _first_tensor(x: Any) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    items = x.values() if isinstance(x, dict) else x
    for item in items:
        try:
            return _first_tensor(item)
        except TypeError:
            continue
    raise TypeError(f"no tensor in {type(x).__name__}")


def force(x: Any) -> float:
    """Wait for the work that made x (a tensor, or a nest of tuples, lists
    and dicts holding one) and return the sum of its first tensor."""
    t = _first_tensor(x)
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    return float(t.to(torch.float32).sum())


def warmup_device(device="cuda") -> float:
    """Absorb the card's first-use costs (context, cuBLAS handle) before any
    timing; returns the seconds spent. A no-op on the CPU."""
    t0 = time.perf_counter()
    dev = torch.device(device)
    if dev.type == "cuda":
        x = torch.ones((128, 128), dtype=torch.float32, device=dev)
        force(x @ x)
    return time.perf_counter() - t0


def gpu_line() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
    them (a card below its 700 W limit runs slower under load)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]
