"""High-level Engine: bucketing, right-padding, greedy generation.

Port of ``fastkv_tpu.engine.generate.Engine`` for all seven methods (FastKV,
FullKV, SnapKV, H2O, StreamingLLM, GemFilter and PyramidInfer) on the Llama
and Mistral families (sliding window or not). Prompts are right-padded to the
smallest bucket that holds the longest one (``pick_bucket``), so shapes come
from a small closed set as in the JAX package. GemFilter runs two passes: its
token selection at that bucket (``engine.gemfilter``), then a FullKV prefill
of the reduced prompt at ``filter_capacity`` with fresh positions, and greedy
decode with FullKV semantics from the reduced length. PyramidInfer runs its
pyramidal prefill with the decode score state, then its own greedy decode
with generation-stage re-compression (``engine.pyramid``).
``EngineConfig.fuse_window_scores`` and ``kv_int8`` reach prefill and decode
as in the JAX package, and int8 weights (``core.quant``) run as they are;
PyramidInfer ignores ``fuse_window_scores`` (as the JAX package does) and
refuses ``kv_int8`` (the JAX package's pyramid prefill writes a bf16 cache
whatever the flag says). ``EngineConfig.debug_checks`` runs ``generate``
with the NaN/Inf and index checks of ``utils.guards`` on. The engine runs on
``cuda`` unless the caller passes ``device="cpu"``; without a card it raises.
On a card, decode replays one CUDA graph a step, captured at the first call
of its shape and kept by the Engine with a cache of that shape
(``engine.decode.greedy_generate``'s ``states``). DeepSeek-V2 runs FastKV
and FullKV through the same calls on one device; its family's ``check``
(``models.family``) refuses the rest at construction.

Over a mesh (``pcfg``, ``mesh`` from ``parallel.sharding.make_mesh``; JAX
:31-40, :67): every rank calls ``generate`` with the whole batch and its own
shard of the params (``sharding.shard_params`` or ``core.weights.
load_params(mesh=)``). Each data replica takes its rows
(``Mesh.batch_rows``; a batch that does not split over the replicas runs
whole on each, as the JAX package's unsharded batch does); the ranks of one
replica (its model x seq x pipe ranks) run the same rows: its seq groups
prefill them sequence-parallel, its model ranks run their heads and MLP
columns, its pipe stages their layers (``engine.prefill``,
``engine.decode``), and every rank of it gets the same logits and picks the
same tokens; the replicas' tokens are gathered over the data group, so every
rank returns the whole batch's. The bucket is the one the whole batch picks.
GemFilter and PyramidInfer run over the model and pipe ranks without
sequence parallelism (each seq rank runs the whole sequence), as the JAX
package runs them without SP. The engine runs on the mesh's device.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from fastkv_tpu_torch.core.config import (
    EngineConfig,
    Method,
    MethodConfig,
    ModelConfig,
    pick_bucket,
)
from fastkv_tpu_torch.core.device import resolve_device
from fastkv_tpu_torch.engine import decode as decode_mod
from fastkv_tpu_torch.engine import gemfilter
from fastkv_tpu_torch.engine import prefill as prefill_mod
from fastkv_tpu_torch.engine import pyramid
from fastkv_tpu_torch.models import family
from fastkv_tpu_torch.parallel import comm
from fastkv_tpu_torch.utils import guards, profiling


def check_pyramid_kv_int8(mcfg: MethodConfig, ecfg: EngineConfig) -> None:
    """PyramidInfer keeps a bf16 (model dtype) cache: it refuses ``kv_int8``."""
    if mcfg.method == Method.PYRAMIDINFER and ecfg.kv_int8:
        raise ValueError("PyramidInfer does not take kv_int8: its cache is kept in the "
                         "model's dtype")


class Engine:
    def __init__(
        self,
        params: Dict[str, Any],
        cfg: ModelConfig,
        mcfg: MethodConfig,
        ecfg: Optional[EngineConfig] = None,
        device=None,  # default: cuda, or the mesh's device
        pcfg=None,  # ParallelConfig (default: the mesh's)
        mesh=None,  # parallel.sharding.Mesh
    ):
        if mesh is not None:
            pcfg = mesh.pcfg if pcfg is None else pcfg
            if pcfg != mesh.pcfg:
                raise ValueError(f"pcfg {pcfg} is not the mesh's {mesh.pcfg}")
            if device is not None and resolve_device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's {mesh.device}")
            device = mesh.device
        elif pcfg is not None and pcfg.num_devices > 1:
            raise ValueError("a ParallelConfig over more than one device needs its mesh")
        self.device = resolve_device("cuda" if device is None else device)
        self.pcfg, self.mesh = pcfg, mesh
        if cfg.sliding_window is not None and cfg.sliding_window < 1:
            raise ValueError(f"sliding_window {cfg.sliding_window} must be >= 1 (or None)")
        self.params = params
        self.cfg = cfg
        self.mcfg = mcfg
        self.ecfg = ecfg or EngineConfig()
        family.of(cfg).check(cfg, mcfg, self.ecfg, params, mesh, pcfg)
        check_pyramid_kv_int8(mcfg, self.ecfg)
        # host-clock seconds of the last generate() call's phases, each ended
        # by a device synchronisation: {"prefill_s", "decode_s",
        # "decode_steps"}; GemFilter adds "pass1_s" and "pass2_s", whose sum
        # is its "prefill_s" (the time to the first token)
        self.last_timing: Dict[str, float] = {}
        self._calls = itertools.count()  # the number of a generate() call, on its spans
        # decode's static buffers and CUDA graph, one a decode shape
        # (decode.greedy_generate's states): each holds a copy of its shape's cache
        self._decode_states: Dict[Any, decode_mod.DecodeState] = {}

    def shapes_for(self, bucket: int, max_new: int) -> prefill_mod.PrefillShapes:
        """The prefill and cache plan of one bucket; GemFilter's is its second
        pass's: FullKV at the bucket's filter capacity."""
        ecfg = dataclasses.replace(self.ecfg, max_new_tokens=max_new)
        if self.mcfg.method == Method.GEMFILTER:
            return gemfilter.pass2_shapes(self.cfg, self.mcfg, ecfg, bucket)
        return prefill_mod.plan_shapes(self.cfg, self.mcfg, ecfg, bucket)

    def _sync(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    @torch.inference_mode()
    def generate(
        self,
        input_ids: Sequence[Sequence[int]],
        max_new_tokens: int,
        eos_ids: Sequence[int] = (),
        min_new_tokens: int = 1,
    ) -> List[List[int]]:
        """Greedy generation. Returns generated token ids per example
        (EOS included if produced)."""
        with guards.checking(self.ecfg.debug_checks):
            return self._generate(input_ids, max_new_tokens, eos_ids, min_new_tokens)

    def _generate(self, input_ids, max_new_tokens, eos_ids, min_new_tokens):
        bucket = pick_bucket(max(len(x) for x in input_ids), self.ecfg.prefill_buckets)
        mesh = self.mesh
        split = mesh is not None and mesh.data > 1 and len(input_ids) % mesh.data == 0
        if split:  # this data replica's rows
            input_ids = list(input_ids)[mesh.batch_rows(len(input_ids))]
        b = len(input_ids)
        lens = [len(x) for x in input_ids]
        with profiling.span("engine.generate", req=next(self._calls), rows=b, bucket=bucket,
                            lens=lens):
            tokens = np.zeros((b, bucket), np.int32)
            for i, ids in enumerate(input_ids):
                tokens[i, : lens[i]] = np.asarray(ids, np.int32)
            tokens_t = torch.from_numpy(tokens).to(self.device)
            n_true = torch.tensor(lens, dtype=torch.int32, device=self.device)
            shapes = self.shapes_for(bucket, max_new_tokens)

            mcfg, timing = self.mcfg, {}
            t0 = self._sync()
            with profiling.span("engine.prefill", device=True):
                if mcfg.method == Method.GEMFILTER:
                    # pass 1 at the bucket; pass 2 is a fresh, shorter prompt through
                    # FullKV's prefill and decode, its positions from 0
                    tokens_t, n_true, _ = gemfilter.select_tokens(
                        self.params, self.cfg, mcfg, self.ecfg, tokens_t, n_true, shapes.bucket,
                        mesh)
                    mcfg = gemfilter.pass2_config(mcfg)
                    timing["pass1_s"] = self._sync() - t0
                step_fn = None
                if mcfg.method == Method.PYRAMIDINFER:
                    logits, cache, pstate = pyramid.prefill(
                        self.params, self.cfg, mcfg, self.ecfg, shapes, tokens_t, n_true,
                        want_decode_state=True, mesh=mesh)
                    step_fn = pyramid.generation_step(self.params, self.cfg, mcfg, shapes, pstate,
                                                      n_true, mesh)
                else:
                    pcfg = None if self.mcfg.method == Method.GEMFILTER else self.pcfg
                    logits, cache = prefill_mod.prefill(
                        self.params, self.cfg, mcfg, shapes, tokens_t, n_true, self.ecfg,
                        pcfg=pcfg, mesh=mesh)
                t1 = self._sync()
            if timing:
                timing["pass2_s"] = t1 - t0 - timing["pass1_s"]
            result, _ = decode_mod.greedy_generate(
                self.params, self.cfg, mcfg, shapes, logits, cache, n_true,
                max_new_tokens, list(eos_ids) if eos_ids else None, min_new_tokens, step_fn, mesh,
                states=self._decode_states)
            toks, nums = result.tokens, result.num_generated
            if split:  # every replica's rows, in batch order
                toks = comm.all_gather(toks, self.mesh.data_group, dim=0)
                nums = comm.all_gather(nums, self.mesh.data_group, dim=0)
            toks, nums = toks.cpu().numpy(), nums.cpu().numpy()
            t2 = self._sync()
            self.last_timing = {"prefill_s": t1 - t0, **timing, "decode_s": t2 - t1,
                                "decode_steps": max_new_tokens - 1}
            return [toks[i, : nums[i]].tolist() for i in range(len(toks))]
