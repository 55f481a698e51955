"""Chunked prefill: an admission's prefill split into fixed-size token chunks.

Port of ``fastkv_tpu.engine.chunked``. A monolithic prefill of a long prompt
stalls every running request's token stream for the whole prefill. Here the
admission runs as a sequence of bounded chunk steps, and the Scheduler runs
decode steps between them, so a running request's longest inter-token gap is
one chunk (plus the finish step), not one whole prefill.

  * ``chunk_step`` runs the pre-compression segment (FastKV: layers
    [0, tsp_idx]; the other methods: all layers) over one [1, chunk] token
    slice (``models.family.prefill_layer``). Its attention writes the
    chunk's K/V into an uncompressed scratch [Lseg, 1, KH, bucket, d] at the
    chunk's offset and attends the chunk's queries against it through the
    flash kernel's rectangular form: key positions are the scratch indices,
    keys at or beyond ``k_hi = min(start + c, n)`` are invalid, and the kernel
    loads no key tile from ``k_hi`` on. The observation-window query rows
    (global rows [n - W, n)) are captured into a [Lseg, 1, H, W, d] buffer.
  * ``finish`` replays the method's eviction from the scratch (window scores
    from the captured rows, keep-set, gather into the compressed cache, int8
    under ``EngineConfig.kv_int8``). For FastKV it also takes the TSP set from
    the TSP layer's scores, gathers the segment-A hidden states and runs
    segment B over the reduced sequence, through the monolithic layer body:
    with ``fuse_window_scores`` segment B's flash calls score the window, as
    in the JAX package (the chunks' rectangular calls do not fuse).

The pipeline computes the same attention rows, window scores and keep/TSP
sets as the monolithic ``engine.prefill``. It must keep the pre-compression
segment's full-length K/V for the whole admission (later chunks attend to
them): a FullKV-prefill-sized scratch, the usual cost of chunked prefill.

Supported: FullKV, FastKV, SnapKV and StreamingLLM, as in the JAX package
(``supported``). H2O scores every query row against every key, which a chunk
pipeline would have to accumulate chunk by chunk, and GemFilter runs two
passes of its own: the Scheduler admits both monolithically.
Nothing here is compiled: ``ChunkPrograms`` is plain Python over the chunk
and finish steps.

Over a mesh (``make_programs(mesh=)``, a Scheduler replica over model and
pipe ranks) a rank runs its ``parallel.pipeline.Part``: the scratch holds its
kv heads and its stage's layers of the chunked segment, each chunk runs the
stages in turn, the finish replays each stage's own layers, TSP's set is
taken on the stage that holds the TSP layer and segment B runs on the
stages, and the last stage's logits go to every stage.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from fastkv_tpu_torch.cache.kv_cache import KVCache
from fastkv_tpu_torch.core.config import EngineConfig, Method, MethodConfig, ModelConfig
from fastkv_tpu_torch.core.device import torch_dtype
from fastkv_tpu_torch.engine import prefill as pm
from fastkv_tpu_torch.models import family, llama
from fastkv_tpu_torch.ops import flash_prefill
from fastkv_tpu_torch.parallel import pipeline
from fastkv_tpu_torch.policies import budgets, methods, selection

SUPPORTED = (Method.FULLKV, Method.FASTKV, Method.SNAPKV, Method.STREAMINGLLM)


def supported(mcfg: MethodConfig, cfg: ModelConfig) -> bool:
    """Whether ``mcfg``'s method can admit chunk by chunk on ``cfg``'s model
    family (``CHUNKED_ADMISSION``: DeepSeek-V2's latent attention admits
    whole, its chunks would need the flash kernel's rectangular form at
    q/k 192, v 128)."""
    return mcfg.method in SUPPORTED and family.of(cfg).CHUNKED_ADMISSION


def _segment_layers(cfg: ModelConfig, mcfg: MethodConfig) -> int:
    """Layers [0, seg) run chunked; for FastKV that is through the TSP layer."""
    if mcfg.method == Method.FASTKV:
        return mcfg.tsp_idx + 1
    return cfg.num_layers


@dataclasses.dataclass
class ChunkPrograms:
    """The chunk and finish steps and their static plan for one (cfg, mcfg,
    ecfg, bucket)."""

    cfg: ModelConfig
    mcfg: MethodConfig
    ecfg: EngineConfig
    shapes: pm.PrefillShapes
    chunk: int
    seg: int  # chunked segment depth
    mesh: Any = None  # parallel.sharding.Mesh: the params are this rank's shard

    @property
    def part(self) -> pipeline.Part:
        return pipeline.part(self.cfg, self.mesh)

    def _seg_layers(self, part: pipeline.Part) -> range:
        """This stage's layers of the chunked segment."""
        return range(part.lo, min(part.hi, self.seg))

    def scratch(self, device) -> Tuple[torch.Tensor, ...]:
        """The uncompressed K/V scratch, the window-row buffer and the hidden
        buffer in the model's dtype (``cfg.dtype``, whatever the weights'
        storage), each written in place by ``chunk_step``. FastKV needs the
        full segment-A hidden states at finish ([1, bucket, D]); the other
        methods only the last valid token's row ([1, 1, D]).

        Contents need no zeroing between admissions: chunk_step writes slots
        [0, start + c) before any read, and every consumer masks by j < n."""
        part = self.part
        cfg, S, n = part.cfg, self.shapes.bucket, len(self._seg_layers(part))
        dtype = torch_dtype(cfg.dtype)
        sk = torch.zeros((n, 1, cfg.num_kv_heads, S, cfg.head_dim), dtype=dtype, device=device)
        sv = torch.zeros_like(sk)
        qwin = torch.zeros((n, 1, cfg.num_heads, self.mcfg.window_size, cfg.head_dim),
                           dtype=dtype, device=device)
        h_rows = S if self.mcfg.method == Method.FASTKV else 1
        hbuf = torch.zeros((1, h_rows, cfg.hidden_size), dtype=dtype, device=device)
        return sk, sv, qwin, hbuf

    def chunk_step(self, params: Dict[str, Any], sk, sv, qwin, hbuf,
                   tokens: torch.Tensor, start: int, n: int) -> None:
        """One chunk (tokens [1, c], global rows [start, start + c)) through
        layers [0, seg), in place into the scratch buffers."""
        part = self.part
        cfg, tp, W, S = part.cfg, part.tp, self.mcfg.window_size, self.shapes.bucket
        dev = tokens.device
        c = tokens.shape[1]
        qpos = (start + torch.arange(c, dtype=torch.int32, device=dev))[None]  # [1, c] global
        kpos = torch.arange(S, dtype=torch.int32, device=dev)[None]
        kv_count = torch.tensor([min(start + c, n)], dtype=torch.int32, device=dev)
        # window capture plan: global rows [n - W, n) -> qwin slots [0, W)
        lo, hi = max(n - W, start), min(n, start + c)

        def layer(st, l):
            li = l - part.lo

            def attend(q, k, v):  # q [1, H, c, d], k/v [1, KH, c, d], roped
                sk[li, :, :, start:start + c] = k
                sv[li, :, :, start:start + c] = v
                # the chunk's queries against the bucket-sized scratch; the kernel
                # skips the key tiles from k_hi on, which nothing can see yet
                return flash_prefill.flash_attention(
                    q, sk[li], sv[li], qpos, kv_count, sliding_window=cfg.sliding_window,
                    k_positions=kpos, k_count=kv_count, k_hi=kv_count), None

            h, _, q, _, _, _ = family.prefill_layer(
                family.of(cfg).layer_params(params, li), cfg, st[0], qpos, attend, l, tp=tp)
            if lo < hi:  # observation-window rows that pass through this chunk
                qwin[li, :, :, lo - (n - W):hi - (n - W)] = q[:, :, lo - start:hi - start]
            return (h,)

        h0 = (llama.embed(params, cfg, tokens),) if part.stage == 0 else None  # [1, c, D]
        out = pipeline.run_layers(part, 0, self.seg, h0, layer)
        if out is None:  # the stage that holds layer seg - 1 keeps the rows
            return
        (h,) = out
        # this chunk's hidden rows: FastKV keeps all of them at their global
        # offset; the others only the last valid token's, for the finish logits
        if self.mcfg.method == Method.FASTKV:
            hbuf[:, start:start + c] = h
        elif start <= n - 1 < start + c:
            hbuf.copy_(h[:, n - 1 - start:n - start])

    def finish(self, params: Dict[str, Any], sk, sv, qwin, hbuf,
               n: int) -> Tuple[torch.Tensor, KVCache]:
        """Replay eviction from the scratch (and, for FastKV, run segment B)
        -> (logits [1, V] float32, compressed cache)."""
        part = self.part
        cfg, tp, mcfg, shapes = part.cfg, part.tp, self.mcfg, self.shapes
        W, S, dev = mcfg.window_size, shapes.bucket, sk.device
        fastkv = mcfg.method == Method.FASTKV
        n_t = torch.tensor([n], dtype=torch.int32, device=dev)
        pos = torch.arange(S, dtype=torch.int32, device=dev)[None]
        state = pm.SeqState(h=hbuf if fastkv else None, positions=pos, valid=pos < n_t[:, None],
                            count=n_t, n_orig=n_t)
        win_idx, win_valid = selection.window_indices(n_t - W, W, n_t)
        store = pm.StackedCache(part.num_layers, shapes.decode_capacity)
        ctx = None
        for l in self._seg_layers(part):
            li = l - part.lo
            ks, ctx = pm.keep_from_window(cfg, mcfg, shapes, state, qwin[li], win_idx,
                                          win_valid, sk[li], is_post_tsp=False)
            store(li, pm._gather_cache(sk[li], sv[li], state, ks, self.ecfg.kv_int8))
        holds_last = part.stage == part.stage_of(self.seg - 1)
        logits = None
        if not fastkv:
            if holds_last:
                logits = llama.unembed(params, cfg, hbuf, tp)[:, 0, :]
        else:
            state_b = None
            if holds_last:  # the TSP set from the TSP layer's scores (its scratch layer)
                raw, selectable, _, _ = ctx
                tsp = methods.fastkv_tsp_set(mcfg, cfg, raw, selectable, win_idx, win_valid,
                                             budgets.dynamic_tsp_budget(mcfg, n_t),
                                             shapes.tsp_capacity, tp)
                state_b = pm.tsp_gather(state, tsp)
            fn_b = pm.make_layer_fn(cfg, mcfg, shapes, is_post_tsp=True, ecfg=self.ecfg, tp=tp)
            state_b = pm.run_segment(part, fn_b, state_b, params, self.seg, self.cfg.num_layers,
                                     store)
            if state_b is not None:
                logits = pm.last_token_logits(params, cfg, state_b, tp)
        [logits] = part.share(part.pipe - 1, None if logits is None else [logits], dev)
        return logits, store.cache


def make_programs(cfg: ModelConfig, mcfg: MethodConfig, shapes: pm.PrefillShapes,
                  chunk: int, ecfg: Optional[EngineConfig] = None, mesh=None) -> ChunkPrograms:
    if not supported(mcfg, cfg):
        raise ValueError(f"chunked admission does not take {mcfg.method.value} on {cfg.kind}")
    if shapes.bucket % chunk:
        raise ValueError(f"prefill_chunk {chunk} must divide the bucket {shapes.bucket}")
    if mcfg.method == Method.FASTKV and not 0 <= mcfg.tsp_idx < cfg.num_layers:
        raise ValueError(f"tsp_idx {mcfg.tsp_idx} is not a layer of a "
                         f"{cfg.num_layers}-layer model")
    return ChunkPrograms(cfg=cfg, mcfg=mcfg, ecfg=ecfg or EngineConfig(), shapes=shapes,
                         chunk=chunk, seg=_segment_layers(cfg, mcfg), mesh=mesh)


@dataclasses.dataclass
class Admission:
    """Host-side progress of one chunked admission."""

    slot: int
    req: Any
    tokens: torch.Tensor  # [1, bucket] right-padded, on the params' device
    n: int
    start: int = 0
    sk: Optional[torch.Tensor] = None
    sv: Optional[torch.Tensor] = None
    qwin: Optional[torch.Tensor] = None
    hbuf: Optional[torch.Tensor] = None  # FastKV: [1, bucket, D] segment-A hidden
    #   states; others: [1, 1, D] last-valid-token row; written in place per chunk
    progs: Optional[ChunkPrograms] = None  # the programs this admission runs under
    #   (set by the Scheduler, which makes them per admission bucket)

    @property
    def last_chunk(self) -> bool:
        """Whether the next ``advance`` runs the last chunk, and the finish."""
        return self.start + self.progs.chunk >= min(self.n, self.progs.shapes.bucket)


def start_admission(progs: ChunkPrograms, params: Dict[str, Any], slot: int, req,
                    prompt: List[int]) -> Admission:
    """Allocate the scratch on the params' device and stage the prompt."""
    bucket = progs.shapes.bucket
    n = len(prompt)
    # over-length prompts are settled at submit time (Scheduler.submit's
    # middle-truncate or reject policy), never cut here
    if not 1 <= n <= bucket:
        raise ValueError(f"prompt length {n} outside [1, {bucket}]")
    tokens = np.zeros((1, bucket), np.int32)
    tokens[0, :n] = prompt
    dev = params["embed"].device
    adm = Admission(slot=slot, req=req, tokens=torch.from_numpy(tokens).to(dev), n=n,
                    progs=progs)
    adm.sk, adm.sv, adm.qwin, adm.hbuf = progs.scratch(dev)
    return adm


def advance(params: Dict[str, Any], adm: Admission) -> Optional[Tuple[torch.Tensor, KVCache]]:
    """Run one chunk of ``adm`` under its programs; on the final chunk, run
    finish and return (logits, cache). Returns None while more chunks remain."""
    progs = adm.progs
    c = progs.chunk
    start, last = adm.start, adm.last_chunk
    progs.chunk_step(params, adm.sk, adm.sv, adm.qwin, adm.hbuf,
                     adm.tokens[:, start:start + c], start, adm.n)
    adm.start = start + c
    if not last:
        return None
    out = progs.finish(params, adm.sk, adm.sv, adm.qwin, adm.hbuf, adm.n)
    adm.sk = adm.sv = adm.qwin = adm.hbuf = None  # released
    return out
