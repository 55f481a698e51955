"""Typed configuration tree for the PyTorch engine.

Own copy of the configuration of ``fastkv_tpu.core.config`` (same class and
field names, same presets), so the port imports nothing of the JAX package.
It holds only what the ported slices read: the Llama and Mistral families
and the presets table, DeepSeek-V2 and -V3 (``DeepSeekV2Config``: latent
attention, routed and shared experts, a share of them, YaRN), the seven methods (PyramidInfer with its
reference-format JSON configs, shipped in ``fastkv_tpu_torch/configs``),
greedy decode and the continuous-batching Scheduler with chunked admission,
fused window scores and int8 (weights and the KV cache), ``from_hf_config``
for checkpoints, ``debug_checks`` (``utils.guards``) and the mesh layout
(``ParallelConfig``: data, tensor, sequence and pipeline parallelism). The TPU-only knobs (Pallas
switches) are left out: the port has one route per device.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import math
import os
from typing import ClassVar, Optional, Tuple, Union


class Method(str, enum.Enum):
    """KV-management methods (same values as the JAX package)."""

    FULLKV = "fullkv"
    FASTKV = "fastkv"
    SNAPKV = "snapkv"
    H2O = "h2o"
    STREAMINGLLM = "streamingllm"
    GEMFILTER = "gemfilter"
    PYRAMIDINFER = "pyramidinfer"


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """Llama-3 style rope scaling (HF ``rope_scaling`` with ``rope_type="llama3"``)."""

    factor: float = 8.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192
    rope_type: str = "llama3"


@dataclasses.dataclass(frozen=True)
class YarnScaling:
    """YaRN rope scaling (HF ``rope_scaling`` with ``type="yarn"``, as
    DeepSeek-V2's ``modeling_deepseek.py`` applies it): the low frequencies
    divided by ``factor``, the high ones kept, a linear ramp between the
    correction dims of ``beta_fast`` and ``beta_slow`` rotations; cos/sin
    times yarn_mscale(factor, mscale) / yarn_mscale(factor, mscale_all_dim),
    the softmax scale times yarn_mscale(factor, mscale_all_dim) squared."""

    factor: float = 40.0
    original_max_position_embeddings: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0
    rope_type: str = "yarn"


def yarn_mscale(factor: float, mscale: float = 1.0) -> float:
    """YaRN's attention factor: 0.1 * mscale * ln(factor) + 1 (1 for factor <= 1)."""
    if factor <= 1:
        return 1.0
    return 0.1 * mscale * math.log(factor) + 1.0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2). A token's keys and values
    come from one latent: ``kv_a`` maps the hidden state to ``kv_lora_rank``
    (RMS-normed) + ``qk_rope_head_dim`` (one roped key every query head
    shares), ``kv_b`` maps the latent to each head's ``qk_nope_head_dim``
    key part and ``v_head_dim`` value. The cache holds the latent and the
    roped key: one cache head a layer. The query is ``wq`` (h) without a
    query LoRA (``q_lora_rank`` None: DeepSeek-V2), else ``q_b``
    (RMSNorm(``q_a`` (h))) through ``q_lora_rank`` values (DeepSeek-V3)."""

    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    q_lora_rank: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """DeepSeek's experts: layers from ``first_k_dense_replace`` on hold
    ``n_routed_experts`` SwiGLU experts of ``moe_intermediate_size``, of
    which a float32 router picks ``num_experts_per_tok``, plus
    ``n_shared_experts`` that every token takes (one SwiGLU of n_shared x
    moe_intermediate_size); the layers before it are dense SwiGLU MLPs of
    ``intermediate_size``. Two routers, as HF's ``MoEGate`` has them:

      * ``greedy`` (DeepSeek-V2): softmax scores, the top k weighted by
        their scores as they are (``norm_topk_prob`` False,
        ``routed_scaling_factor`` 1);
      * ``noaux_tc`` (DeepSeek-V3): sigmoid scores; the choice adds the
        layer's correction bias and keeps the ``topk_group`` best of
        ``n_group`` groups (a group scores the sum of its two best); the top
        k are weighted by their sigmoid scores, renormalised when
        ``norm_topk_prob``, times ``routed_scaling_factor``.

    Expert parallelism's share: ``ep_size`` devices share each expert layer
    and this one holds ``n_routed_experts`` of the router's
    ``router_experts`` (n_routed_experts x ep_size), the ``ep_rank``-th
    block. It routes over all of them and computes its own experts' part."""

    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    moe_intermediate_size: int = 1408
    n_shared_experts: int = 2
    first_k_dense_replace: int = 1
    topk_method: str = "greedy"
    n_group: int = 1
    topk_group: int = 1
    norm_topk_prob: bool = False
    routed_scaling_factor: float = 1.0
    ep_size: int = 1
    ep_rank: int = 0

    @property
    def router_experts(self) -> int:
        """The router's width: the experts of every device sharing the layer."""
        return self.n_routed_experts * self.ep_size


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters for the Llama and Mistral families
    (DeepSeek-V2's: ``DeepSeekV2Config``)."""

    name: str = "tiny"
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 500000.0
    rope_scaling: Optional[Union[RopeScaling, YarnScaling]] = None
    rms_norm_eps: float = 1e-5
    sliding_window: Optional[int] = None
    tie_word_embeddings: bool = False
    max_position_embeddings: int = 131072
    # weights and KV cache type on the card; norms, softmax and selection
    # math run in float32 either way
    dtype: str = "bfloat16"
    # the model family (``models.family.of`` picks its layer code by it)
    kind: ClassVar[str] = "llama"

    @property
    def num_kv_groups(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def rope_dim(self) -> int:
        """The dims RoPE rotates: the whole head."""
        return self.head_dim

    @property
    def softmax_scale(self) -> float:
        """head_dim^-0.5, times YaRN's mscale_all_dim factor squared."""
        scale = self.head_dim ** -0.5
        rs = self.rope_scaling
        if isinstance(rs, YarnScaling) and rs.mscale_all_dim:
            m = yarn_mscale(rs.factor, rs.mscale_all_dim)
            scale = scale * m * m
        return scale

    @classmethod
    def tiny(cls, **kw) -> "ModelConfig":
        """A CPU-runnable debug config used by unit tests."""
        base = dict(
            name="tiny",
            vocab_size=256,
            hidden_size=64,
            intermediate_size=128,
            num_layers=4,
            num_heads=4,
            num_kv_heads=2,
            head_dim=16,
            rope_theta=10000.0,
            rope_scaling=None,
            rms_norm_eps=1e-6,
            max_position_embeddings=4096,
            dtype="float32",
        )
        base.update(kw)
        return cls(**base)

    @classmethod
    def llama_3_2_1b(cls, **kw) -> "ModelConfig":
        base = dict(
            name="llama-3.2-1b",
            vocab_size=128256,
            hidden_size=2048,
            intermediate_size=8192,
            num_layers=16,
            num_heads=32,
            num_kv_heads=8,
            head_dim=64,
            rope_theta=500000.0,
            rope_scaling=RopeScaling(factor=32.0),
            tie_word_embeddings=True,
        )
        base.update(kw)
        return cls(**base)

    @classmethod
    def llama_3_2_3b(cls, **kw) -> "ModelConfig":
        base = dict(
            name="llama-3.2-3b",
            vocab_size=128256,
            hidden_size=3072,
            intermediate_size=8192,
            num_layers=28,
            num_heads=24,
            num_kv_heads=8,
            head_dim=128,
            rope_theta=500000.0,
            rope_scaling=RopeScaling(factor=32.0),
            tie_word_embeddings=True,
        )
        base.update(kw)
        return cls(**base)

    @classmethod
    def llama_3_1_8b(cls, **kw) -> "ModelConfig":
        base = dict(
            name="llama-3.1-8b",
            vocab_size=128256,
            hidden_size=4096,
            intermediate_size=14336,
            num_layers=32,
            num_heads=32,
            num_kv_heads=8,
            head_dim=128,
            rope_theta=500000.0,
            rope_scaling=RopeScaling(factor=8.0),
        )
        base.update(kw)
        return cls(**base)

    @classmethod
    def llama_3_1_70b(cls, **kw) -> "ModelConfig":
        base = dict(
            name="llama-3.1-70b",
            vocab_size=128256,
            hidden_size=8192,
            intermediate_size=28672,
            num_layers=80,
            num_heads=64,
            num_kv_heads=8,
            head_dim=128,
            rope_theta=500000.0,
            rope_scaling=RopeScaling(factor=8.0),
        )
        base.update(kw)
        return cls(**base)

    @classmethod
    def ministral_8b(cls, **kw) -> "ModelConfig":
        # Ministral-8B-Instruct-2410: 36 layers, SWA 32768 (interleaved=every layer
        # in HF release), GQA 32/8, head_dim 128, vocab 131072.
        base = dict(
            name="ministral-8b",
            vocab_size=131072,
            hidden_size=4096,
            intermediate_size=12288,
            num_layers=36,
            num_heads=32,
            num_kv_heads=8,
            head_dim=128,
            rope_theta=100000000.0,
            sliding_window=32768,
        )
        base.update(kw)
        return cls(**base)

    @classmethod
    def mistral_nemo_12b(cls, **kw) -> "ModelConfig":
        # Mistral-Nemo-Instruct-2407: no sliding window; its query width
        # 32 x 128 = 4096 differs from its hidden size 5120.
        base = dict(
            name="mistral-nemo-12b",
            vocab_size=131072,
            hidden_size=5120,
            intermediate_size=14336,
            num_layers=40,
            num_heads=32,
            num_kv_heads=8,
            head_dim=128,
            rope_theta=1000000.0,
        )
        base.update(kw)
        return cls(**base)

    @classmethod
    def from_hf_config(cls, hf_cfg, name: str = "hf") -> "ModelConfig":
        """From an HF ``config.json`` (a dict, or an object with ``to_dict``):
        llama3 ``rope_scaling``, an explicit ``head_dim`` (Nemo),
        ``sliding_window`` (Mistral) and ``tie_word_embeddings``; a
        ``deepseek_v2`` or ``deepseek_v3`` config gives a ``DeepSeekV2Config``."""
        if not isinstance(hf_cfg, dict):
            hf_cfg = hf_cfg.to_dict()
        if hf_cfg.get("model_type") in ("deepseek_v2", "deepseek_v3"):
            return DeepSeekV2Config.from_hf(hf_cfg, name)
        rs = hf_cfg.get("rope_scaling")
        rope_scaling = None
        if rs and rs.get("rope_type", rs.get("type")) == "llama3":
            rope_scaling = RopeScaling(
                factor=rs["factor"],
                low_freq_factor=rs["low_freq_factor"],
                high_freq_factor=rs["high_freq_factor"],
                original_max_position_embeddings=rs["original_max_position_embeddings"],
            )
        num_heads = hf_cfg["num_attention_heads"]
        return cls(
            name=name,
            vocab_size=hf_cfg["vocab_size"],
            hidden_size=hf_cfg["hidden_size"],
            intermediate_size=hf_cfg["intermediate_size"],
            num_layers=hf_cfg["num_hidden_layers"],
            num_heads=num_heads,
            num_kv_heads=hf_cfg.get("num_key_value_heads", num_heads),
            head_dim=hf_cfg.get("head_dim") or hf_cfg["hidden_size"] // num_heads,
            rope_theta=hf_cfg.get("rope_theta", 10000.0),
            rope_scaling=rope_scaling,
            rms_norm_eps=hf_cfg.get("rms_norm_eps", 1e-5),
            sliding_window=hf_cfg.get("sliding_window"),
            tie_word_embeddings=hf_cfg.get("tie_word_embeddings", False),
            max_position_embeddings=hf_cfg.get("max_position_embeddings", 131072),
        )


@dataclasses.dataclass(frozen=True)
class DeepSeekV2Config(ModelConfig):
    """DeepSeek-V2 and -V3: MLA attention and experts (V3: a query LoRA, the
    ``noaux_tc`` router, a share of the experts; ``from_hf``). ``num_kv_heads``
    is the cache heads, 1 (one latent row a token and layer), ``head_dim``
    the query/key width (nope + rope), ``intermediate_size`` the dense
    layers' MLP."""

    mla: MLAConfig = MLAConfig()
    moe: MoEConfig = MoEConfig()
    kind: ClassVar[str] = "deepseek_v2"

    @property
    def rope_dim(self) -> int:
        """The dims RoPE rotates: MLA's rope part."""
        return self.mla.qk_rope_head_dim

    @classmethod
    def lite(cls, **kw) -> "DeepSeekV2Config":
        # DeepSeek-V2-Lite: 27 layers, MLA over 16 heads (q/k 192, v 128,
        # latent 512 + rope 64), layer 0 dense, then 64 routed experts top 6
        # + 2 shared; YaRN x40 from 4096 positions
        base = dict(
            name="deepseek-v2-lite",
            vocab_size=102400,
            hidden_size=2048,
            intermediate_size=10944,
            num_layers=27,
            num_heads=16,
            num_kv_heads=1,
            head_dim=192,
            rope_theta=10000.0,
            rope_scaling=YarnScaling(factor=40.0, original_max_position_embeddings=4096,
                                     beta_fast=32.0, beta_slow=1.0, mscale=0.707,
                                     mscale_all_dim=0.707),
            rms_norm_eps=1e-6,
            max_position_embeddings=163840,
            mla=MLAConfig(),
            moe=MoEConfig(),
        )
        base.update(kw)
        return cls(**base)

    @classmethod
    def tiny(cls, **kw) -> "DeepSeekV2Config":
        """A CPU-runnable DeepSeek-V2 for unit tests: 1 dense layer + 3 expert
        layers of 8 experts (top 2) + 1 shared, q/k 24 wide (16 + 8), v 12,
        a latent of 32, YaRN x4 from 64 positions (so test prompts reach the
        interpolated frequencies)."""
        base = dict(
            name="tiny-deepseek-v2",
            vocab_size=256,
            hidden_size=64,
            intermediate_size=128,
            num_layers=4,
            num_heads=4,
            num_kv_heads=1,
            head_dim=24,
            rope_theta=10000.0,
            rope_scaling=YarnScaling(factor=4.0, original_max_position_embeddings=64,
                                     beta_fast=32.0, beta_slow=1.0, mscale=0.707,
                                     mscale_all_dim=0.707),
            rms_norm_eps=1e-6,
            max_position_embeddings=4096,
            dtype="float32",
            mla=MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                          v_head_dim=12),
            moe=MoEConfig(n_routed_experts=8, num_experts_per_tok=2, moe_intermediate_size=32,
                          n_shared_experts=1, first_k_dense_replace=1),
        )
        base.update(kw)
        return cls(**base)

    @classmethod
    def from_hf(cls, hf: dict, name: str = "hf") -> "DeepSeekV2Config":
        """A ``deepseek_v2`` or ``deepseek_v3`` config: MLA (one latent cache
        head, so ``num_kv_heads`` 1 whatever ``num_key_value_heads`` says),
        experts, YaRN. What the port does not run raises NotImplementedError
        naming the key. Of a ``deepseek_v2`` config: a query LoRA, grouped
        routing, another scoring or top-k method, renormalised or scaled
        expert weights, experts on only some layers, biases on the attention
        projections. A ``deepseek_v3`` config takes a query LoRA and its
        router as HF's V3 ``MoEGate`` runs it (``noaux_tc`` over sigmoid
        scores, groups, renormalised and scaled weights) and refuses any
        other; its ``n_routed_experts`` are the experts held here, ``ep_size``
        the devices that share a layer (the router spans n_routed_experts x
        ep_size), ``ep_rank`` (default 0) which block is held. Its
        multi-token-prediction module (``num_nextn_predict_layers``) drafts
        tokens for speculative decoding and is not built, as HF's modeling
        code builds none: no next-token logit depends on it."""
        kind = hf.get("model_type", "deepseek_v2")
        if kind == "deepseek_v3":
            refuse = [("attention_bias", bool(hf.get("attention_bias", False))),
                      ("topk_method", hf.get("topk_method") != "noaux_tc"),
                      ("scoring_func", hf.get("scoring_func") != "sigmoid"),
                      ("moe_layer_freq", hf.get("moe_layer_freq", 1) != 1)]
        else:
            refuse = [("q_lora_rank", hf.get("q_lora_rank") is not None),
                      ("attention_bias", bool(hf.get("attention_bias", False))),
                      ("topk_method", hf.get("topk_method", "greedy") != "greedy"),
                      ("scoring_func", hf.get("scoring_func", "softmax") != "softmax"),
                      ("moe_layer_freq", hf.get("moe_layer_freq", 1) != 1),
                      ("n_group", hf.get("n_group") not in (None, 1)),
                      ("norm_topk_prob", bool(hf.get("norm_topk_prob", False))),
                      ("routed_scaling_factor", hf.get("routed_scaling_factor", 1.0) != 1)]
        for key, bad in refuse:
            if bad:
                raise NotImplementedError(f"{kind}: {key}={hf.get(key)!r} is not ported")
        rs = hf.get("rope_scaling")
        rope_scaling = None
        if rs:
            if rs.get("type", rs.get("rope_type")) != "yarn":
                raise NotImplementedError(f"{kind}: rope_scaling {rs!r} is not ported")
            rope_scaling = YarnScaling(
                factor=float(rs["factor"]),
                original_max_position_embeddings=rs["original_max_position_embeddings"],
                beta_fast=float(rs.get("beta_fast", 32)), beta_slow=float(rs.get("beta_slow", 1)),
                mscale=float(rs.get("mscale", 1)),
                mscale_all_dim=float(rs.get("mscale_all_dim", 0)))
        mla = MLAConfig(kv_lora_rank=hf["kv_lora_rank"], qk_nope_head_dim=hf["qk_nope_head_dim"],
                        qk_rope_head_dim=hf["qk_rope_head_dim"], v_head_dim=hf["v_head_dim"])
        moe = MoEConfig(
            n_routed_experts=hf["n_routed_experts"], num_experts_per_tok=hf["num_experts_per_tok"],
            moe_intermediate_size=hf["moe_intermediate_size"],
            n_shared_experts=hf.get("n_shared_experts") or 0,
            first_k_dense_replace=hf.get("first_k_dense_replace", 0))
        if kind == "deepseek_v3":
            mla = dataclasses.replace(mla, q_lora_rank=hf.get("q_lora_rank"))
            moe = dataclasses.replace(
                moe, topk_method="noaux_tc", n_group=hf.get("n_group") or 1,
                topk_group=hf.get("topk_group") or 1,
                norm_topk_prob=bool(hf.get("norm_topk_prob", False)),
                routed_scaling_factor=float(hf.get("routed_scaling_factor", 1.0)),
                ep_size=hf.get("ep_size") or 1, ep_rank=hf.get("ep_rank") or 0)
            _check_router(moe)
        return cls(
            name=name,
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_layers=hf["num_hidden_layers"],
            num_heads=hf["num_attention_heads"],
            num_kv_heads=1,
            head_dim=mla.qk_nope_head_dim + mla.qk_rope_head_dim,
            rope_theta=float(hf.get("rope_theta", 10000.0)),
            rope_scaling=rope_scaling,
            rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
            tie_word_embeddings=hf.get("tie_word_embeddings", False),
            max_position_embeddings=hf.get("max_position_embeddings", 163840),
            mla=mla,
            moe=moe,
        )


def _check_router(moe: MoEConfig) -> None:
    """ValueError for a ``noaux_tc`` router its groups or share do not fit."""
    E, G = moe.router_experts, moe.n_group
    if E % G or E // G < 2 or not 1 <= moe.topk_group <= G:
        raise ValueError(f"deepseek_v3: {E} router experts in {G} groups, keeping "
                         f"{moe.topk_group}: a group needs two experts at least")
    if moe.num_experts_per_tok > moe.topk_group * (E // G):
        raise ValueError(f"deepseek_v3: top {moe.num_experts_per_tok} of the "
                         f"{moe.topk_group * (E // G)} experts the kept groups hold")
    if not 0 <= moe.ep_rank < moe.ep_size:
        raise ValueError(f"deepseek_v3: ep_rank {moe.ep_rank} of ep_size {moe.ep_size}")


MODEL_PRESETS = {
    "tiny": ModelConfig.tiny,
    "llama-3.2-1b": ModelConfig.llama_3_2_1b,
    "llama-3.2-3b": ModelConfig.llama_3_2_3b,
    "llama-3.1-8b": ModelConfig.llama_3_1_8b,
    "llama-3.1-70b": ModelConfig.llama_3_1_70b,
    "ministral-8b": ModelConfig.ministral_8b,
    "mistral-nemo-12b": ModelConfig.mistral_nemo_12b,
}

# the shipped PyramidInfer configs, copies of the JAX package's
PYRAMIDINFER_CONFIGS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs", "pyramidinfer")


@dataclasses.dataclass(frozen=True)
class MethodConfig:
    """KV-management method hyperparameters.

    Canonical FastKV operating point (Llama-3.1-8B): proportional eviction,
    tsp_rate 0.2, retain_rate 0.1, tsp_idx 15, window 8, maxpool kernel 7.
    """

    method: Method = Method.FASTKV
    # SnapKV-style observation window (last W prompt tokens kept verbatim)
    window_size: int = 8
    # 1-D pooling over attention-mass scores before top-k
    kernel_size: int = 7
    pooling: str = "maxpool"  # 'avgpool' | 'maxpool'
    # 'constant' uses absolute budgets; 'proportional' derives them from the
    # true prompt length
    eviction_mode: str = "proportional"
    max_capacity_prompt: int = 512  # constant-mode per-layer KV budget
    tsp_len: int = 2048  # constant-mode TSP propagation length
    retain_rate: float = 0.1  # proportional-mode KV budget = retain_rate * n
    tsp_rate: float = 0.2  # proportional-mode tsp_len = tsp_rate * n
    tsp_idx: int = 15  # layer whose output is token-selected (fastkv)
    filter_idx: int = 13  # gemfilter selection layer (the reference's eval_longbench.sh)
    # PyramidInfer (the reference's pyramidinfer_configs/*.json keys in brackets)
    pyramid_recent_ratio: float = 0.2  # [recent_ratio]
    pyramid_decay_ratio: float = 0.7  # [prefill_decay_ratio]
    pyramid_decay_strategy: str = "cosine"  # 'cosine' | 'linear' [prefill_decay_strategy]
    pyramid_min_context_length: int = 64  # [min_context_length]
    pyramid_sink_len: int = 4  # [streamingllm_sink_len]
    pyramid_distance_weight: float = 1.2  # [distance_weight]
    pyramid_downsample_interval: int = 1  # [layerwise_downsample_interval]
    # generation-stage re-compression ("generation_stage" keys)
    pyramid_gen_decay_ratio: float = 1.0
    pyramid_gen_decay_strategy: str = "cosine"
    pyramid_gen_compress_ratio: float = 0.9
    pyramid_exceed_length_to_compress: int = 16

    def with_pyramidinfer_json(self, source) -> "MethodConfig":
        """Overlay a reference-format PyramidInfer config (a path, a dict or
        a file object): {"prefill_stage": {recent_ratio, prefill_decay_ratio,
        prefill_decay_strategy, min_context_length,
        layerwise_downsample_interval, streamingllm_sink_len,
        distance_weight}, "generation_stage": {gen_decay_ratio,
        gen_decay_strategy, gen_compress_ratio, exceed_length_to_compress}}.
        A missing key keeps this config's value."""
        if isinstance(source, str):
            with open(source) as f:
                data = json.load(f)
        elif hasattr(source, "read"):
            data = json.load(source)
        else:
            data = source
        p = data.get("prefill_stage", {})
        g = data.get("generation_stage", {})
        return dataclasses.replace(
            self,
            method=Method.PYRAMIDINFER,
            pyramid_recent_ratio=p.get("recent_ratio", self.pyramid_recent_ratio),
            pyramid_decay_ratio=p.get("prefill_decay_ratio", self.pyramid_decay_ratio),
            pyramid_decay_strategy=p.get("prefill_decay_strategy", self.pyramid_decay_strategy),
            pyramid_min_context_length=p.get("min_context_length",
                                             self.pyramid_min_context_length),
            pyramid_downsample_interval=p.get("layerwise_downsample_interval",
                                              self.pyramid_downsample_interval),
            pyramid_sink_len=p.get("streamingllm_sink_len", self.pyramid_sink_len),
            pyramid_distance_weight=p.get("distance_weight", self.pyramid_distance_weight),
            pyramid_gen_decay_ratio=g.get("gen_decay_ratio", self.pyramid_gen_decay_ratio),
            pyramid_gen_decay_strategy=g.get("gen_decay_strategy",
                                             self.pyramid_gen_decay_strategy),
            pyramid_gen_compress_ratio=g.get("gen_compress_ratio",
                                             self.pyramid_gen_compress_ratio),
            pyramid_exceed_length_to_compress=g.get("exceed_length_to_compress",
                                                    self.pyramid_exceed_length_to_compress),
        )

    def with_pyramidinfer_preset(self, model_name: str, retain_rate: float) -> "MethodConfig":
        """The shipped PyramidInfer config of a (model family, retain rate)
        pair, as the reference picks its path: a name with "nemo" is the
        Nemo family, one with "ministral" or "mistral" the Ministral family,
        any other Llama. Raises NotImplementedError for a pair with no file."""
        low = model_name.lower()
        fam = "llama"
        if "nemo" in low:
            fam = "nemo"
        elif "ministral" in low or "mistral" in low:
            fam = "ministral"
        path = os.path.join(PYRAMIDINFER_CONFIGS, f"{fam}_{int(round(retain_rate * 100))}.json")
        if not os.path.exists(path):
            raise NotImplementedError(
                f"No pyramidinfer config for model={model_name!r} "
                f"retain_rate={retain_rate} (looked for {path})")
        return self.with_pyramidinfer_json(path)


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Mesh layout. Axes: data (batch replicas), model (tensor parallelism:
    attention heads, MLP columns and an untied head's vocabulary), seq
    (sequence-parallel prefill), pipe (layer stages), expert (a stub).

    ``parallel.sharding.make_mesh`` places the ranks; ``sp_mode`` 'ring'
    rotates K/V chunks around the ``seq`` ranks, 'ulysses' reshards sequence
    to heads by all-to-all, 'none' runs no sequence parallelism.
    ``check_model`` raises where a model does not split over the mesh."""

    data: int = 1
    model: int = 1
    seq: int = 1
    pipe: int = 1
    # the reference models are dense: no parameter shards on this axis
    expert: int = 1
    sp_mode: str = "none"

    def __post_init__(self):
        for name in ("data", "model", "seq", "pipe", "expert"):
            if getattr(self, name) < 1:
                raise ValueError(f"ParallelConfig.{name} must be >= 1")
        if self.sp_mode not in ("none", "ring", "ulysses"):
            raise ValueError(f"unknown sp_mode {self.sp_mode!r}")
        if self.expert > 1:
            raise ValueError("expert must stay 1: the dense models shard nothing on it")

    def check_model(self, cfg: "ModelConfig") -> None:
        """ValueError where ``cfg`` does not split over this mesh the way the
        JAX package's sharding splits it: heads, kv heads and MLP columns
        over ``model`` (and an untied head's vocabulary), layers over
        ``pipe``."""
        m = self.model
        splits = [("num_kv_heads", cfg.num_kv_heads, m), ("num_heads", cfg.num_heads, m),
                  ("intermediate_size", cfg.intermediate_size, m),
                  ("num_layers", cfg.num_layers, self.pipe)]
        if not cfg.tie_word_embeddings:
            splits.append(("vocab_size", cfg.vocab_size, m))
        for name, n, ways in splits:
            if n % ways:
                axis = "pipe" if name == "num_layers" else "model"
                raise ValueError(f"{cfg.name}: {name} {n} does not split over {axis}={ways}")

    @property
    def num_devices(self) -> int:
        return self.data * self.model * self.seq * self.pipe * self.expert


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine-level knobs: batching, shape bucketing, generation."""

    # prompt lengths are right-padded up to the nearest bucket
    prefill_buckets: Tuple[int, ...] = (
        512, 1024, 2048, 4096, 8192, 16384, 32768, 65536, 131072)
    max_new_tokens: int = 256
    # pad compressed-cache capacity to a multiple of this
    capacity_align: int = 128
    # Chunked admission in the Scheduler (engine.chunked): a request admitted
    # while others decode is prefilled in chunks of this many tokens, one
    # chunk between decode steps, so a running request's longest inter-token
    # gap is one chunk (+ the finish step), not one whole prefill. None =
    # monolithic admission. A bucket the chunk does not divide (and an empty
    # prompt) admits monolithically. Idle admissions are monolithic anyway.
    prefill_chunk: Optional[int] = None
    # decode steps run per admission chunk (1 = one step between chunks)
    chunk_decode_steps: int = 1
    # FastKV and SnapKV: score the observation window inside the flash kernel
    # (``flash_attention(window_q=...)``), which then also returns the scores
    # [b, H, s], instead of in a separate pass that reads K again. The JAX
    # package gives up the fusion past ~106K tokens (its ``fusion_vmem_ok``,
    # a limit of the TPU's scoped VMEM); the scores are exact either way, so
    # the port fuses at every length and no result changes.
    fuse_window_scores: bool = False
    # store the KV cache as int8 with one float32 absmax scale per (head,
    # slot) (``core.quant.quantize_kv``); the decode kernel folds the scales
    # into its logits and probabilities, so no dequantized cache exists
    kv_int8: bool = False
    # check every layer boundary of prefill and decode (hidden states, q/k/v,
    # logits) for NaN/Inf and every gather's indices for bounds, raising an
    # error that names the layer (``utils.guards``); each check reads its
    # tensor back to the host, so it is a debugging switch, off by default
    debug_checks: bool = False
    # the prefill MLP over the sequence in chunks of this many tokens
    # (``models.llama.mlp(chunk=)``), which caps its [s, intermediate]
    # activations: at Llama-3.1-8B and s = 131072 each of the gate, the up
    # projection and their product is 3.76 GB in bf16. 0 = never; None =
    # auto: 32768 once s >= 131072
    mlp_chunk: Optional[int] = None

    def mlp_chunk_for(self, s: int) -> int:
        """The MLP chunk for a prefill of s tokens: ``mlp_chunk``, or the auto
        choice, halved until it divides s; 0 (no chunking) unless 1 < chunk
        < s."""
        if self.mlp_chunk is not None:
            chunk = self.mlp_chunk
        elif s >= 131072:
            chunk = 32768
        else:
            return 0
        while chunk > 1 and s % chunk:
            chunk //= 2
        return chunk if 1 < chunk < s else 0


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pick_bucket(n: int, buckets: Tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"sequence length {n} exceeds largest bucket {buckets[-1]}")
