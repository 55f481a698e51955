"""fastkv_tpu_torch: the PyTorch/CUDA port of fastkv_tpu for one NVIDIA H100.

The JAX package ``fastkv_tpu`` stays the reference. This package keeps its
module layout and function names, so each counterpart is easy to find, and
imports nothing of it (nor JAX): it keeps its own copy of what it needs.

Slices ported so far: ``engine.generate.Engine.generate`` and the
continuous-batching ``engine.scheduler.Scheduler`` (with chunked admission,
``engine.chunked``) for FastKV (two-segment prefill with Token-Selective
Propagation), FullKV, SnapKV, H2O, StreamingLLM, GemFilter (two passes,
``engine.gemfilter``) and PyramidInfer (``engine.pyramid``, with its
calibration CLI ``bench.calibrate``) on the Llama and Mistral families, with both TPU
kernels rewritten by hand for Hopper in CUDA C++ (``kernels/csrc``): flash
prefill, causal square or rectangular with a ``k_hi`` key gate, with or
without a sliding window (``ops.flash_prefill``), and decode attention over
the compressed cache (``ops.decode_attn``). Checkpoints load through the
port's own safetensors reader (``core.weights``); the LongBench, RULER and
needle evals (``evals``) and the latency and throughput CLIs
(``bench.latency``, ``bench.throughput``) run on them. Requests are served
across Scheduler replicas by ``engine.serve.FrontDoor`` (failure detection
and re-admission) and across processes by ``engine.dispatch`` (a
coordinator's queue that workers pull, with leases). Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""

from fastkv_tpu_torch.engine.dispatch import Coordinator, serve_worker
from fastkv_tpu_torch.engine.scheduler import Request, Scheduler
from fastkv_tpu_torch.engine.serve import FrontDoor, init_distributed, local_front_door

__all__ = ["Coordinator", "FrontDoor", "Request", "Scheduler", "init_distributed",
           "local_front_door", "serve_worker"]
__version__ = "0.1.0"
