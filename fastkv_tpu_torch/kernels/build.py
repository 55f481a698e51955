"""Builds the port's CUDA kernels from the sources in ``csrc/`` and loads them.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o <build dir>/<name>-<hash>.so csrc/<name>.cu

loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds). The
build happens at first use, into ``build/kernels/`` at the root of the
checkout (listed in ``.gitignore``); the file name carries a hash of the
sources and flags, so an edited source is rebuilt. ``build()`` starts one
``nvcc`` per missing library, all at once. A failed build raises with
nvcc's stderr; nothing falls back to the plain versions.

Threads may launch kernels at once (the serving replicas do): ``build`` and
``load`` hold one module lock, so a library is built and bound once a
process, and a temporary output is named by process and thread.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNELS = ("flash_prefill", "decode_attn", "decode_prologue", "add_rms_norm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # csrc/common.cuh dtype codes

_lock = threading.RLock()  # held by build() and load()
_loaded: Dict[str, ctypes.CDLL] = {}
_sms: Dict[int, int] = {}


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, Path]:
    """Compile every missing library in parallel; returns name -> .so path.
    The ptxas report (registers, shared memory, spills) of a fresh build is
    kept beside the library as ``<name>-<hash>.log``."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        paths = {n: library_path(n) for n in names}
        procs = {}
        for n, path in paths.items():
            if path.exists():
                continue
            tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), tmp)
        failures = []
        for n, (proc, tmp) in procs.items():
            out, err = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"nvcc failed for {n} (exit {proc.returncode}):\n{err}{out}")
                continue
            paths[n].with_suffix(".log").write_text(err + out)
            os.replace(tmp, paths[n])
        if failures:
            raise RuntimeError("\n".join(failures))
        return paths


def build_log(name: str) -> str:
    """The ptxas report of the current build of ``name`` ('' if built elsewhere)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library for ``name``, building it first if needed; ``bind``
    declares its entry points' signatures."""
    with _lock:
        if name not in _loaded:
            lib = ctypes.CDLL(str(build([name])[name]))
            lib.fastkv_error_string.argtypes = [ctypes.c_int]
            lib.fastkv_error_string.restype = ctypes.c_char_p
            bind(lib)
            _loaded[name] = lib
        return _loaded[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.fastkv_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def num_sms(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]
