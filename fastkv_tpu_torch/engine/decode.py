"""Decode: single-token step over the compressed cache + greedy generation loop.

Port of ``fastkv_tpu.engine.decode``. Decode token t has position n_true + t
(positions continue from the original prompt length) and goes into the static
cache slot prefill_capacity + t, written in place; the continuous-batching
Scheduler passes one slot per example instead, as its slots sit at different
depths. Attention runs through ``ops.decode_attn.decode_attention``: the CUDA
kernel on the card, its plain version on the CPU. Under a sliding window it
sees the last ``sliding_window`` cache entries by rank (``window_mask``).
Each layer is ``models.family.decode_layer``: between the layer's
projections and its attention, the family's ``decode_qkv`` turns the new
token by RoPE and writes its cache row at the slot in one kernel launch on
the card (``ops.decode_prologue``), and its two norm sites, the second
with the attention's residual add, are one launch each
(``ops.add_rms_norm``). An int8 cache
(``EngineConfig.kv_int8``) gets the new token's K/V quantized, with their
scales written at the same slot, and the kernel folds the layer's scales
in. A layer's projections, attention and MLP are its family's:
DeepSeek-V2 writes its new latent and rope key into its one cache head and
attends over the latents as they are, with the query absorbed into the
latent (``ops.latent_attn``), and computes its experts from ids that stay
on the device, so its step is captured whole too.

Over a mesh (``decode_step(mesh=)``) a rank runs its ``parallel.pipeline.
Part``: its cache holds its cache heads and its stage's layers, each step
runs the stages in turn (the [b, 1, D] hidden state handed on), and the last
stage's logits go to every stage, so ``greedy_generate`` picks the same
tokens on every rank.

A step is a few thousand small launches, so on a card the host would set
its pace. Where it can (``graphable``: a card, no mesh of more than one
rank, the default step, the guards off), ``greedy_generate`` and the
Scheduler run the step as one CUDA graph (``StepGraph``): captured once,
then replayed for every later step of the same shapes. The step reads its
token, position and slot from static buffers (``DecodeState``) and
advances them on the device, so a replay needs no input from the host.
Everywhere else the same step runs eagerly.
"""

from __future__ import annotations

import functools
import threading
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from fastkv_tpu_torch.cache.kv_cache import KVCache, write_slot
from fastkv_tpu_torch.core.config import MethodConfig, ModelConfig
from fastkv_tpu_torch.engine.prefill import PrefillShapes
from fastkv_tpu_torch.models import family, llama
from fastkv_tpu_torch.models.rope import inv_freq_on
from fastkv_tpu_torch.ops import add_rms_norm, decode_attn, decode_prologue
from fastkv_tpu_torch.parallel import pipeline
from fastkv_tpu_torch.utils import guards, profiling


def window_mask(valid: torch.Tensor, sliding_window: Optional[int]) -> torch.Tensor:
    """The cache slots a decode step attends, [..., C] bool.

    Without a window, every valid slot. Under a window, the last
    ``sliding_window`` valid entries in cache order, not by original position,
    as the JAX package's decode_step (after the reference's Mistral cache
    slicing): a compressed cache shorter than the window keeps far-past kept
    tokens visible. Kept slots form an ordered prefix and decode slots append
    after it, so an entry's rank is a cumulative sum over ``valid``."""
    if sliding_window is None:
        return valid
    rank = torch.cumsum(valid.to(torch.int32), dim=-1, dtype=torch.int32)
    return valid & (rank > rank[..., -1:] - sliding_window)


def decode_step(
    params: Dict[str, Any],
    cfg: ModelConfig,
    mcfg: MethodConfig,
    cache: KVCache,
    token: torch.Tensor,  # [b] int32
    pos: torch.Tensor,  # [b] int32: original position of this token
    slot: Union[int, torch.Tensor],  # cache slot: one int, or a [b] tensor per example
    inv_freq: Optional[torch.Tensor] = None,
    mesh=None,  # parallel.sharding.Mesh: the params and cache are this rank's shard
) -> Tuple[torch.Tensor, KVCache]:
    """One decode step. Returns (logits [b, V] float32, the cache updated in
    place). ``cfg`` is the whole model's."""
    with profiling.span("decode.step", b=token.shape[0], graph=0):
        if inv_freq is None:
            inv_freq = inv_freq_on(cfg, token.device)
        b = token.shape[0]
        rows = None  # one arange a step for every per-example slot write
        if not isinstance(slot, int):
            slot = slot.to(device=token.device, dtype=torch.long)
            rows = torch.arange(b, device=token.device)
        part = pipeline.part(cfg, mesh)
        lcfg, tp = part.cfg, part.tp
        ch = cache.k.shape[2]
        # in place at the slot, and a step never copies the cache; the new slot's
        # position and validity are the same in every layer, so they are written
        # for all of the stage's layers at once (through a [b, CH, C, L] view),
        # and the mask taken after
        write_slot(cache.pos.permute(1, 2, 3, 0),
                   pos[:, None, None].expand(b, ch, part.num_layers), slot, rows)
        write_slot(cache.valid.permute(1, 2, 3, 0), cache.valid.new_ones(()), slot, rows)
        attend = window_mask(cache.valid, cfg.sliding_window)  # [L, b, CH, C]

        def layer(st, l):
            guards.at(f"decode layer {l}")
            i = l - part.lo
            h, _ = family.decode_layer(family.of(cfg).layer_params(params, i), lcfg, st[0], pos,
                                       inv_freq, cache, i, slot, rows, mask=attend[i], tp=tp)
            return (h,)

        h0 = (llama.embed(params, cfg, token[:, None]),) if part.stage == 0 else None  # [b, 1, D]
        with profiling.span("decode.layers"):
            out = pipeline.run_layers(part, 0, cfg.num_layers, h0, layer)
        logits = None
        if out is not None:
            with profiling.span("decode.head"):
                guards.at("the LM head")
                logits = llama.unembed(params, cfg, out[0], tp)[:, 0, :]
                guards.finite("logits", logits)
        [logits] = part.share(part.pipe - 1, None if logits is None else [logits], token.device)
        return logits, cache


class GenResult(NamedTuple):
    tokens: torch.Tensor  # [b, max_new] int32 (0 after EOS)
    num_generated: torch.Tensor  # [b] int32


# one decode step of the generation loop: (cache, token [b], step t, inv_freq)
# -> (logits [b, V], cache)
StepFn = Callable[[KVCache, torch.Tensor, int, torch.Tensor], Tuple[torch.Tensor, KVCache]]


def graphable(device: torch.device, mesh=None) -> bool:
    """Whether the default decode step on ``device`` may run as a captured
    CUDA graph: on a card, without a mesh or over a one-rank one (a
    collective over gloo cannot be captured), with the guards off (their
    checks read the card)."""
    return (device.type == "cuda" and (mesh is None or mesh.pcfg.num_devices == 1)
            and not guards.enabled())


class StepGraph:
    """One decode step captured as a CUDA graph, replayed for every later
    step. The step must read and write only tensors at fixed addresses (the
    caller's static buffers and cache, the params), so a replay redoes it
    on what they hold then.

    The first call runs the step eagerly on the graph's own stream, which
    builds the kernels and makes that stream's decode-kernel arrival
    counters and cuBLAS workspace outside the capture, then captures it
    there under a ``decode.capture`` span; each later call replays it on
    that stream under a ``decode.step`` span with the count ``graph=1``.
    Both are ordered with the caller's stream both ways, as the counters
    ask (``ops.decode_attn._arrival_counters``). A replay counts the decode
    kernel's, the prologue's and the norm kernel's launches it makes
    (``decode_attn.count_launches``, ``decode_prologue.count_launches``,
    ``add_rms_norm.count_launches``); the capture's span records the
    prologue's and the norm's as the counts ``prologue`` and ``norm``."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches = (0, 0, 0)  # decode_attn's counts of one replay
        self.prologue = 0  # decode_prologue's launches of one replay
        self.norm = 0  # add_rms_norm's launches of one replay

    def __call__(self, step: Callable[[], None], **counts) -> None:
        caller = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(caller)
        with torch.cuda.stream(self.stream):
            if self.graph is None:
                step()
                with profiling.span("decode.capture", **counts) as sp:
                    self.graph = torch.cuda.CUDAGraph()
                    # a freed stream's handle is reused: drop the counts an
                    # earlier capture on a stream at this handle left
                    decode_attn.take_captured(self.stream.cuda_stream)
                    decode_prologue.take_captured(self.stream.cuda_stream)
                    add_rms_norm.take_captured(self.stream.cuda_stream)
                    # capture_begin, not torch.cuda.graph(): that one empties
                    # the allocator's cache, which the next prefill would
                    # pay for again
                    self.graph.capture_begin(capture_error_mode="thread_local")
                    try:
                        step()
                    finally:
                        self.graph.capture_end()
                    self.launches = decode_attn.take_captured(self.stream.cuda_stream)
                    self.prologue = decode_prologue.take_captured(self.stream.cuda_stream)
                    self.norm = add_rms_norm.take_captured(self.stream.cuda_stream)
                    if sp is not None:
                        sp.counts.update(prologue=self.prologue, norm=self.norm)
            else:
                with profiling.span("decode.step", graph=1, **counts):
                    self.graph.replay()
                decode_attn.count_launches(*self.launches)
                decode_prologue.count_launches(self.prologue)
                add_rms_norm.count_launches(self.norm)
        caller.wait_stream(self.stream)


class DecodeState:
    """The static buffers of ``greedy_generate``'s loop: the ``cache`` its
    steps decode over; per row the token the next step feeds (``tok``), its
    position and cache slot, whether the row has ended, the tokens counted
    so far and the token matrix (its width the cache's slots + 1, more than
    any call decodes); the 0-d index ``t`` of the token the next step
    picks, ``min_new`` and the [V] EOS mask. A step reads and advances them
    on the device, so it can run as a CUDA graph (``graph``, or None to
    run eagerly)."""

    def __init__(self, cache: KVCache, vocab: int, inv_freq: torch.Tensor,
                 graph: Optional[StepGraph] = None):
        b, dev = cache.k.shape[1], cache.k.device

        def zeros(dtype, *shape):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.cache, self.inv_freq, self.graph = cache, inv_freq, graph
        self.tok, self.pos, self.slot = zeros(torch.int32, b), zeros(torch.int32, b), zeros(
            torch.int64, b)
        self.done, self.count = zeros(torch.bool, b), zeros(torch.int32, b)
        self.tokens = zeros(torch.int32, b, cache.k.shape[3] + 1)
        self.t, self.min_new = zeros(torch.int64), zeros(torch.int64)
        self.eos = zeros(torch.bool, vocab)
        self.lock = threading.Lock()  # held by the call that uses the buffers

    def start(self, first_logits: torch.Tensor, n_true: torch.Tensor, first_slot: int,
              eos_ids: Optional[Sequence[int]], min_new_tokens: int) -> None:
        """Load a call: its EOS ids and minimum, its first token (picked from
        the prefill's logits), the positions and slot the first step takes."""
        self.eos.zero_()
        if eos_ids is not None:
            self.eos[torch.as_tensor(list(eos_ids), dtype=torch.long)] = True
        self.min_new.fill_(min_new_tokens)
        self.t.zero_()
        tok = self.pick(first_logits)
        self.tok.copy_(tok)
        self.tokens[:, 0] = tok
        self.done.copy_(self.eos[tok.long()])
        self.count.fill_(1)
        self.pos.copy_(n_true)
        self.slot.fill_(first_slot)
        self.t.fill_(1)

    def pick(self, logits: torch.Tensor) -> torch.Tensor:
        """Greedy pick of token t; EOS suppressed while t < min_new."""
        banned = self.eos & (self.t < self.min_new)
        return torch.argmax(logits.masked_fill(banned, float("-inf")), dim=-1).to(torch.int32)

    def advance(self, logits: torch.Tensor) -> None:
        """Take a step's logits: pick token t (0 in a row that has ended),
        count it, and move every buffer on by one."""
        tok = torch.where(self.done, 0, self.pick(logits))
        self.count += ~self.done
        self.done |= self.eos[tok.long()]
        self.tok.copy_(tok)
        self.tokens.index_copy_(1, self.t.view(1), tok[:, None])
        self.pos += 1
        self.slot += 1
        self.t += 1


def _copy_cache(dst: KVCache, src: KVCache) -> None:
    for (_, d), (_, s) in zip(dst.fields(), src.fields()):
        d.copy_(s)


def greedy_generate(
    params: Dict[str, Any],
    cfg: ModelConfig,
    mcfg: MethodConfig,
    shapes: PrefillShapes,
    first_logits: torch.Tensor,  # [b, V] from prefill
    cache: KVCache,
    n_true: torch.Tensor,  # [b] int32 original prompt lengths
    max_new_tokens: int,
    eos_ids: Optional[Sequence[int]] = None,
    min_new_tokens: int = 1,
    step_fn: Optional[StepFn] = None,
    mesh=None,  # parallel.sharding.Mesh of the default step (decode_step's)
    states: Optional[Dict[Any, DecodeState]] = None,
) -> Tuple[GenResult, KVCache]:
    """Greedy decoding: at least ``min_new_tokens`` before EOS may win; tokens
    after EOS are 0 and excluded from num_generated. The loop runs all
    max_new_tokens - 1 steps without reading anything back to the host.
    Returns the result and ``cache``, holding the decoded entries.

    ``step_fn(cache, token, t, inv_freq) -> (logits, cache)`` takes decode
    step t (from 0); by default ``decode_step`` at position n_true + t and
    slot prefill_capacity + t, both advanced on the device. PyramidInfer
    passes its own (``engine.pyramid.generation_step``).

    Where the default step is ``graphable``, it runs as a ``StepGraph``.
    ``states`` (a caller's, such as an ``Engine``'s) keeps one
    ``DecodeState`` a key (the method and the cache's fields' shapes and
    dtypes) with a cache of its own and its graph, captured once for all
    of the caller's calls: a call copies its cache in, replays, and copies
    the decoded cache back. The states belong to one set of params and one
    model config. Without ``states``, or where the step runs eagerly, the
    call's buffers are its own and the steps decode over ``cache``."""
    b, vocab = first_logits.shape
    dev = first_logits.device
    if shapes.prefill_capacity + max_new_tokens - 1 > cache.k.shape[3]:
        raise ValueError(f"{max_new_tokens} new tokens after {shapes.prefill_capacity} "
                         f"prefill slots exceed the cache's {cache.k.shape[3]} slots")
    graph = step_fn is None and graphable(dev, mesh)
    key = (mcfg.method, tuple((t.shape, t.dtype) for _, t in cache.fields()))
    st = states.get(key) if graph and states is not None else None
    if st is None:
        inv_freq = inv_freq_on(cfg, dev)
        if graph and states is not None:
            own = KVCache(*(None if t is None else torch.empty_like(t) for t in cache))
            st = states[key] = DecodeState(own, vocab, inv_freq, StepGraph(dev))
        else:
            st = DecodeState(cache, vocab, inv_freq, StepGraph(dev) if graph else None)
    over = {} if mesh is None else {"mesh": mesh}

    def step(t: Optional[int]) -> None:
        if step_fn is None:
            logits, _ = decode_step(params, cfg, mcfg, st.cache, st.tok, st.pos, st.slot,
                                    st.inv_freq, **over)
        else:
            logits, _ = step_fn(st.cache, st.tok, t, st.inv_freq)
        st.advance(logits)

    with st.lock:
        if st.cache is not cache:
            _copy_cache(st.cache, cache)
        st.start(first_logits, n_true, shapes.prefill_capacity, eos_ids, min_new_tokens)
        with profiling.span("decode.loop", steps=max_new_tokens - 1):
            for t in range(max_new_tokens - 1):
                if st.graph is None:
                    step(t)
                else:
                    st.graph(functools.partial(step, None), b=b)
        if st.cache is not cache:
            _copy_cache(cache, st.cache)
        result = GenResult(tokens=st.tokens[:, :max_new_tokens].clone(),
                           num_generated=st.count.clone())
    return result, cache
