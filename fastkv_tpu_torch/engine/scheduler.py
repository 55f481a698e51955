"""Continuous-batching scheduler: slot-based request admission over one shared
decode batch.

Port of ``fastkv_tpu.engine.scheduler`` for all seven methods, on one device or
over a mesh:

  * ``max_batch`` decode slots share one stacked KVCache, its capacity planned
    for the scheduler's largest bucket. Every step runs a full-batch decode
    with one cache slot per example (``engine.decode``); inactive slots
    compute values that are never read. The step's tokens, positions and
    slots go to the device in one copy, and only its picks come back; on a
    card (``engine.decode.graphable``) the step is one CUDA graph, captured
    at the first step and replayed at every later one.
  * Admission: a queued request is prefilled at batch 1 at the smallest
    bucket of the ladder that holds it (the buckets ``Engine.generate`` picks
    from, capped at the scheduler's bucket), and its compressed cache is
    written in place into a free slot; the rest of the slot is cleared, so a
    freed slot keeps nothing of a longer earlier request. A GemFilter
    admission runs its token selection at that bucket, then a FullKV prefill
    of the reduced prompt at the bucket's filter capacity; the shared cache is
    planned at the largest bucket's filter capacity, decoded with FullKV
    semantics from the reduced length (``_decode_mcfg``). PyramidInfer
    admits at the scheduler's one bucket (its score buffer's row count
    depends on the bucket), runs the pyramid prefill with its decode state,
    and installs the state into the slot beside the cache; its decode steps
    are the pyramid step (generation-stage re-compression) with one cache
    slot and one stamp per example, over the shared ``PyramidDecodeState``
    and each slot's prompt length and frozen recent length
    (``int(n * recent_ratio)``, as the JAX Scheduler rounds it).
  * With ``EngineConfig.prefill_chunk`` set, a request admitted while others
    decode is prefilled chunk by chunk (``engine.chunked``), with
    ``chunk_decode_steps`` decode steps between chunks. A bucket that the
    chunk does not divide, and an empty prompt, admit monolithically: that is
    the reference's policy, not a fallback of the device. H2O, GemFilter
    and PyramidInfer always admit monolithically (``chunked.supported``), as
    in the JAX package, and so does DeepSeek-V2 with any method.
  * Over-length prompts: middle truncation (keep the first and the last half
    of the largest bucket) or rejection; never a silent tail drop.
  * Retirement: EOS or the request's budget frees the slot.
  * Streaming intake: ``_run_loop(intake=)`` calls a hook once a loop
    iteration, which may submit requests and keeps the loop running while
    it returns True (``engine.dispatch.serve_worker`` pulls tickets through
    it); ``run`` is ``_run_loop`` without one.
  * Observability: per-request queue time (from ``submit`` to leaving the
    queue, ``admitted_at``), TTFT, TPOT and token counts
    (``Request.metrics``); the bounded ``events`` log of prefill, chunk,
    finish and decode steps, each decode stamped after its tokens reached the
    host; and, while a ``torch.profiler`` session runs, a span of
    ``utils.profiling`` around each admission step.

A replica over a mesh (``pcfg``, ``mesh``: its model, seq and pipe ranks;
one data replica): every rank of it runs this Scheduler and receives the
same submits (SPMD). The params are each rank's shard; the shared cache
holds the rank's cache heads and its stage's layers; prefill, the chunk
pipeline and decode run over the mesh (``engine.prefill``,
``engine.chunked``, ``engine.decode``) and give every rank the same logits,
so every rank picks the same tokens. Admission and retirement read no clock
(the host clock only stamps metrics and events), so the ranks take the same
decisions in the same order.
The scheduler runs on ``cuda`` unless the caller passes ``device="cpu"``;
over a mesh, on the mesh's device.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from fastkv_tpu_torch.cache.kv_cache import empty_cache
from fastkv_tpu_torch.core.config import (
    EngineConfig,
    Method,
    MethodConfig,
    ModelConfig,
    pick_bucket,
)
from fastkv_tpu_torch.core.device import resolve_device, torch_dtype
from fastkv_tpu_torch.engine import chunked
from fastkv_tpu_torch.engine import decode as decode_mod
from fastkv_tpu_torch.engine import gemfilter
from fastkv_tpu_torch.engine import prefill as prefill_mod
from fastkv_tpu_torch.engine import pyramid
from fastkv_tpu_torch.engine.generate import check_pyramid_kv_int8
from fastkv_tpu_torch.models import family
from fastkv_tpu_torch.models.rope import inv_freq_on
from fastkv_tpu_torch.parallel import pipeline
from fastkv_tpu_torch.policies.methods import cache_heads
from fastkv_tpu_torch.utils import profiling

# the events log keeps the newest this many entries of a run
EVENTS_CAP = 1 << 16


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: List[int]
    max_new_tokens: int
    eos_ids: Sequence[int] = ()
    # filled by the scheduler
    submitted_at: float = 0.0
    admitted_at: float = 0.0  # left the queue
    prefill_done_at: float = 0.0
    finished_at: float = 0.0
    tokens: List[int] = dataclasses.field(default_factory=list)

    @property
    def metrics(self) -> Dict[str, Any]:
        n = len(self.tokens)
        decode_time = max(self.finished_at - self.prefill_done_at, 1e-9)
        return {
            "req_id": self.req_id,
            "prompt_len": len(self.prompt),
            "new_tokens": n,
            "queue_s": self.admitted_at - self.submitted_at,
            "ttft_s": self.prefill_done_at - self.submitted_at,
            "tpot_s": decode_time / max(n - 1, 1),
            "total_s": self.finished_at - self.submitted_at,
        }


class Scheduler:
    def __init__(
        self,
        params: Dict[str, Any],
        cfg: ModelConfig,
        mcfg: MethodConfig,
        ecfg: Optional[EngineConfig] = None,
        max_batch: int = 4,
        bucket: int = 4096,
        max_new_tokens: int = 256,
        logger=None,  # any object with request_metrics(req), called at retirement
        overlength: str = "truncate_middle",  # 'truncate_middle' | 'reject'
        pcfg=None,  # ParallelConfig of a replica over a mesh (default: the mesh's)
        mesh=None,  # parallel.sharding.Mesh; the params are this rank's shard
        device="cuda",  # over a mesh: the mesh's device
    ):
        if mesh is not None:
            pcfg = mesh.pcfg if pcfg is None else pcfg
            if pcfg != mesh.pcfg:
                raise ValueError(f"pcfg {pcfg} is not the mesh's {mesh.pcfg}")
            if mesh.data > 1:
                raise ValueError("a Scheduler is one data replica: give each replica of the "
                                 "data axis its own Scheduler over its own mesh")
            device = mesh.device
        elif pcfg is not None and pcfg.num_devices > 1:
            raise ValueError("a ParallelConfig over more than one device needs its mesh")
        fam = family.of(cfg)
        fam.check(cfg, mcfg, ecfg or EngineConfig(), params, mesh, pcfg)
        self.pcfg, self.mesh = pcfg, mesh
        self.part = pipeline.part(cfg, mesh)
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, the scheduler "
                             f"runs on {self.device}")
        if overlength not in ("truncate_middle", "reject"):
            raise ValueError(f"unknown overlength policy {overlength!r}")
        self.logger = logger
        self.params = params
        self.cfg = cfg
        self.mcfg = mcfg
        self.ecfg = dataclasses.replace(ecfg or EngineConfig(), max_new_tokens=max_new_tokens)
        check_pyramid_kv_int8(mcfg, self.ecfg)
        self.max_batch = max_batch
        self.bucket = bucket
        self.max_new = max_new_tokens
        self.overlength = overlength
        # the admission bucket ladder: Engine.generate's buckets below this
        # scheduler's capacity bucket, and that bucket; PyramidInfer's score
        # buffer has a row count of its bucket's, so it admits at that one
        self.pyramid = mcfg.method == Method.PYRAMIDINFER
        self.buckets = (bucket,) if self.pyramid else tuple(
            sorted({b for b in self.ecfg.prefill_buckets if b < bucket} | {bucket}))
        # the method the shared cache is decoded with: GemFilter's second pass
        # is a FullKV prefill, so its slots decode as FullKV's
        self._decode_mcfg = (gemfilter.pass2_config(mcfg)
                             if mcfg.method == Method.GEMFILTER else mcfg)
        self._prefill_shapes: Dict[int, prefill_mod.PrefillShapes] = {}
        self.shapes = self._shapes_for(bucket)
        # the model's dtype, not the weights' storage (int8 weights keep a
        # cfg.dtype cache); int8 only under kv_int8; the planes' widths the
        # family's (MLA: the latent and the rope key)
        k_dim, v_dim = fam.cache_dims(cfg)
        self.cache = empty_cache(
            self.part.num_layers, max_batch, cache_heads(self._decode_mcfg.method, self.part.cfg),
            self.shapes.total_capacity,
            k_dim, dtype=torch_dtype(cfg.dtype), device=self.device,
            kv_int8=self.ecfg.kv_int8, v_dim=v_dim)
        self.inv_freq = inv_freq_on(cfg, self.device)
        if self.pyramid:
            # the shared score state and each slot's prompt length and frozen
            # recent length
            self.pstate = pyramid.empty_decode_state(
                self.part.num_layers, max_batch, pyramid.decode_buffer_rows(mcfg, bucket),
                self.shapes.total_capacity, self.device)
            self.n_orig = np.zeros(max_batch, np.int32)
            self.r_dyn = np.zeros(max_batch, np.int32)
        self.tok = np.zeros(max_batch, np.int32)
        self.pos = np.zeros(max_batch, np.int32)
        self.steps = np.zeros(max_batch, np.int32)
        # a decode step's inputs (token, position, slot) as the device reads
        # them, sent in one copy from a (pinned) host twin, and its picks
        self._step_in = torch.zeros((3, max_batch), dtype=torch.int32, device=self.device)
        self._step_in_host = torch.zeros((3, max_batch), dtype=torch.int32,
                                         pin_memory=self.device.type == "cuda")
        self._next = torch.zeros(max_batch, dtype=torch.int32, device=self.device)
        self._graph: Optional[decode_mod.StepGraph] = None  # captured at the first step
        self.active = np.zeros(max_batch, bool)
        self.slot_req: List[Optional[Request]] = [None] * max_batch

        self.queue: List[Request] = []
        self.finished: List[Request] = []
        self._next_id = 0
        # (kind, req_id) for prefill/chunk/finish, ("decode", host seconds)
        # for decode steps; cleared by run() and capped within a run
        self.events: "collections.deque[tuple]" = collections.deque(maxlen=EVENTS_CAP)

        # chunked admission: per-bucket chunk programs (None: the chunk does
        # not tile that bucket) and the admission in progress
        self._chunk_ok = bool(self.ecfg.prefill_chunk) and chunked.supported(mcfg, cfg)
        self._chunk_progs: Dict[int, Optional[chunked.ChunkPrograms]] = {}
        self._adm: Optional[chunked.Admission] = None

    # -- public API -----------------------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new_tokens: Optional[int] = None,
               eos_ids: Sequence[int] = ()) -> int:
        """Queue a request; returns its id. Its budget may not exceed the
        scheduler's ``max_new_tokens``, which sizes every slot's decode part."""
        prompt = [int(t) for t in prompt]
        budget = max_new_tokens or self.max_new
        if budget > self.max_new:
            raise ValueError(f"max_new_tokens {budget} exceeds the scheduler's {self.max_new}")
        cap = self.buckets[-1]
        if len(prompt) > cap:
            if self.overlength == "reject":
                raise ValueError(
                    f"prompt length {len(prompt)} exceeds the scheduler's largest bucket "
                    f"{cap} (overlength='reject')")
            # the reference protocol's middle truncation: the first and the
            # last half of the largest bucket
            half = cap // 2
            prompt = prompt[:half] + prompt[len(prompt) - (cap - half):]
        req = Request(req_id=self._next_id, prompt=prompt, max_new_tokens=budget,
                      eos_ids=eos_ids, submitted_at=time.perf_counter())
        self._next_id += 1
        self.queue.append(req)
        return req.req_id

    def run(self) -> List[Request]:
        """Drain the queue; returns the finished requests (with metrics).

        While any request runs, at most one admission step (a monolithic
        prefill, or one chunk of a chunked admission) happens per decode
        round, so a burst of arrivals stalls the running requests by one
        admission step at a time, not by all of them back to back. On one
        device the total work is the same: interleaving bounds the longest
        inter-token gap; it cannot take other requests' prefill time out of a
        running request's wall clock. When nothing runs, every free slot
        admits at once (nobody to stall)."""
        self.events.clear()
        return self._run_loop()

    @torch.inference_mode()
    def _run_loop(self, intake: Optional[Callable[[], bool]] = None) -> List[Request]:
        """The drain loop. ``intake`` (streaming dispatch, ``engine.dispatch``)
        is called once an iteration and may submit requests; the loop also
        keeps running while it returns True. Inference mode is set here, not
        only in ``run``: it is a thread's own, and a dispatch worker calls
        this loop on its thread."""
        while True:
            more = intake() if intake is not None else False
            if not (self.queue or self.active.any() or self._adm is not None or more):
                break
            if self._adm is not None:
                self._advance_admission()
            elif self.active.any() and self._chunk_ok and self.queue:
                self._start_chunked_admission()
            else:
                # idle (nobody to stall) or no chunked admission: monolithic
                self._admit(limit=1 if self.active.any() else self.max_batch)
            if self.active.any():
                # chunk_decode_steps decode steps per chunk of an admission in
                # progress; one step per round otherwise
                k = self.ecfg.chunk_decode_steps if self._adm is not None else 1
                for _ in range(max(k, 1)):
                    if not self.active.any():
                        break
                    self._decode_one_step()
        out, self.finished = self.finished, []
        return out

    # -- internals ------------------------------------------------------------------

    def _shapes_for(self, bucket: int) -> prefill_mod.PrefillShapes:
        """The prefill plan of one admission bucket (GemFilter: its second
        pass's, FullKV at the bucket's filter capacity)."""
        if bucket not in self._prefill_shapes:
            plan = (gemfilter.pass2_shapes if self.mcfg.method == Method.GEMFILTER
                    else prefill_mod.plan_shapes)
            self._prefill_shapes[bucket] = plan(self.cfg, self.mcfg, self.ecfg, bucket)
        return self._prefill_shapes[bucket]

    def _chunk_progs_for(self, bucket: int) -> Optional[chunked.ChunkPrograms]:
        """Chunk programs for one bucket; None when the chunk does not tile it."""
        if bucket not in self._chunk_progs:
            chunk = self.ecfg.prefill_chunk
            self._chunk_progs[bucket] = None if bucket % chunk else chunked.make_programs(
                self.cfg, self.mcfg, self._shapes_for(bucket), chunk, self.ecfg, self.mesh)
        return self._chunk_progs[bucket]

    def _admit(self, limit: Optional[int] = None) -> None:
        admitted = 0
        for slot in range(self.max_batch):
            if self.active[slot] or not self.queue:
                continue
            if limit is not None and admitted >= limit:
                break
            admitted += 1
            req = self.queue.pop(0)
            req.admitted_at = time.perf_counter()
            with profiling.span("sched.admit_step", req=req.req_id, device=True, kind="prefill"):
                n = len(req.prompt)
                bucket = pick_bucket(max(n, 1), self.buckets)
                tokens = np.zeros((1, bucket), np.int32)
                tokens[0, :n] = req.prompt
                shapes = self._shapes_for(bucket)
                tokens_t = torch.from_numpy(tokens).to(self.device)
                n_t = torch.tensor([n], dtype=torch.int32, device=self.device)
                if self.mcfg.method == Method.GEMFILTER:
                    # pass 1 at the bucket; decode continues from the reduced length
                    tokens_t, n_t, _ = gemfilter.select_tokens(
                        self.params, self.cfg, self.mcfg, self.ecfg, tokens_t, n_t, shapes.bucket,
                        self.mesh)
                    n = int(n_t[0])
                if self.pyramid:
                    logits, cache1, pstate1 = pyramid.prefill(
                        self.params, self.cfg, self.mcfg, self.ecfg, shapes, tokens_t, n_t,
                        want_decode_state=True, mesh=self.mesh)
                    # the slot's score state, every field of it: the one
                    # admission bucket gives the shared state's shapes
                    for dst, src in zip(self.pstate, pstate1):
                        dst[:, slot] = src[:, 0]
                    self.n_orig[slot] = n
                    self.r_dyn[slot] = int(n * self.mcfg.pyramid_recent_ratio)
                else:
                    pcfg = None if self.mcfg.method == Method.GEMFILTER else self.pcfg
                    logits, cache1 = prefill_mod.prefill(
                        self.params, self.cfg, self._decode_mcfg, shapes, tokens_t, n_t, self.ecfg,
                        pcfg=pcfg, mesh=self.mesh)
                self.events.append(("prefill", req.req_id))
                self._install(slot, req, n, logits, cache1)

    def _install(self, slot: int, req: Request, n: int, logits, cache1) -> None:
        """Write a prefilled request's cache into its decode slot, in place.
        ``n`` is the prompt length decode positions continue from: the
        original one, or GemFilter's reduced count.

        A smaller bucket's cache is shorter than the shared capacity; the
        rest of the slot is cleared (zeros, invalid), as the reference pads
        the installed cache to the whole slot: a freed slot may hold a longer
        earlier request's entries and its decode slots. Each field goes to its
        namesake (the int8 scale planes too)."""
        first = int(torch.argmax(logits[0]))
        req.prefill_done_at = time.perf_counter()
        req.tokens = [first]
        c1 = cache1.k.shape[3]
        if c1 > self.shapes.total_capacity:
            raise ValueError(f"an admission's cache ({c1} slots) exceeds the shared "
                             f"capacity {self.shapes.total_capacity}")
        for name, src in cache1.fields():
            dst = getattr(self.cache, name)
            dst[:, slot, :, :c1] = src[:, 0]
            dst[:, slot, :, c1:] = 0
        self.tok[slot] = first
        self.pos[slot] = n
        self.steps[slot] = 0
        self.active[slot] = True
        self.slot_req[slot] = req
        if first in set(req.eos_ids) or req.max_new_tokens <= 1:
            self._retire(slot)

    def _start_chunked_admission(self) -> None:
        free = [s for s in range(self.max_batch) if not self.active[s]]
        if not self.queue or not free:
            return
        n = len(self.queue[0].prompt)
        progs = self._chunk_progs_for(pick_bucket(n, self.buckets)) if n else None
        if progs is None:
            # an empty prompt (the chunk pipeline never captures its last
            # row) or a bucket the chunk does not tile: monolithic admission
            self._admit(limit=1)
            return
        req = self.queue.pop(0)
        req.admitted_at = time.perf_counter()
        self._adm = chunked.start_admission(progs, self.params, free[0], req, req.prompt)

    def _advance_admission(self) -> None:
        adm = self._adm
        # the span holds the finish's install, as a monolithic admission's does
        with profiling.span("sched.admit_step", req=adm.req.req_id, device=True,
                            kind="finish" if adm.last_chunk else "chunk"):
            out = chunked.advance(self.params, adm)
            self.events.append(("chunk", adm.req.req_id))
            if out is None:
                return
            logits, cache1 = out
            self.events.append(("finish", adm.req.req_id))
            self._adm = None
            self._install(adm.slot, adm.req, adm.n, logits, cache1)

    def _step(self) -> None:
        """The default decode step over the static inputs, its picks into
        ``_next``: what the CUDA graph holds."""
        tok, pos, slot = self._step_in
        logits, _ = decode_mod.decode_step(self.params, self.cfg, self._decode_mcfg, self.cache,
                                           tok, pos, slot, self.inv_freq, self.mesh)
        self._next.copy_(torch.argmax(logits, dim=-1))

    def _decode_one_step(self) -> None:
        host = self._step_in_host.numpy()
        host[0], host[1] = self.tok, self.pos
        host[2] = self.shapes.prefill_capacity + self.steps
        self._step_in.copy_(self._step_in_host, non_blocking=True)
        if self.pyramid:
            tok, pos, slot = self._step_in
            stamps, n_orig, r_dyn = (torch.from_numpy(a).to(self.device)
                                     for a in (self.steps + 1, self.n_orig, self.r_dyn))
            logits, self.cache, self.pstate = pyramid.decode_step(
                self.params, self.cfg, self.mcfg, self.cache, self.pstate, tok, pos,
                slot.long(), stamps, n_orig, r_dyn, self.inv_freq, self.mesh)
            self._next.copy_(torch.argmax(logits, dim=-1))
        elif decode_mod.graphable(self.device, self.mesh):
            if self._graph is None:
                self._graph = decode_mod.StepGraph(self.device)
            self._graph(self._step, b=self.max_batch)
        else:
            self._step()
        nxt = self._next.cpu().numpy()
        # stamped after the tokens reached the host, which ends the step, so
        # the deltas between decode events are the inter-token gaps running
        # requests see (admission work between steps included)
        self.events.append(("decode", time.perf_counter()))
        for slot in range(self.max_batch):
            if not self.active[slot]:
                continue
            req = self.slot_req[slot]
            tok = int(nxt[slot])
            req.tokens.append(tok)
            self.steps[slot] += 1
            self.pos[slot] += 1
            self.tok[slot] = tok
            if tok in set(req.eos_ids) or len(req.tokens) >= req.max_new_tokens:
                self._retire(slot)

    def _retire(self, slot: int) -> None:
        req = self.slot_req[slot]
        req.finished_at = time.perf_counter()
        self.finished.append(req)
        self.active[slot] = False
        self.slot_req[slot] = None
        if self.logger is not None:
            self.logger.request_metrics(req)
