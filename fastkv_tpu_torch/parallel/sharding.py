"""The mesh and the placements: which rank holds which slice of the weights
and of the cache.

Port of ``fastkv_tpu/parallel/sharding.py``. The JAX package reshapes its
devices to (data, model, seq, pipe, expert) and lets the partitioner place
each leaf by its PartitionSpec; here ``make_mesh`` places the ranks of an
initialised process group the same way, global rank ((d * model + m) * seq
+ s) * pipe + p at data replica d, model rank m, sequence place s and pipe
stage p (with model = pipe = 1 that is ``d * seq + s``), and each rank holds
its slice of every leaf explicitly:

  * the specs (``param_pspecs``, ``lm_head_pspec``, ``full_param_pspecs``,
    ``cache_pspec``) are the JAX package's, leaf for leaf, as tuples of axis
    names per dim (None: not split), the contents of its PartitionSpecs;
    Megatron-style TP: wq/wk/wv/w_gate/w_up split on their output dim,
    wo/w_down on their input dim; int8 scales follow their weight's output
    dim (on ``model`` for the column-parallel ones, replicated for the
    row-parallel ones); the embedding and the final norm are replicated, an
    untied head splits on its vocabulary; the stacked layer axis of every
    layer leaf, and of the cache, splits over ``pipe``; the cache splits on
    its head axis over ``model``;
  * ``shard_params`` cuts this rank's slices out of a whole tree, mirroring
    the tree as it stands (a partial int8 tree without the embedding's
    scale); ``core.weights.load_params(mesh=)`` reads only them from a
    checkpoint (``slices``).

Each axis has its groups (``dist.new_group``; every rank creates every group
in one order): the ranks that differ only in that axis's index, in its
order. Nothing is implicit: every collective names one of them
(``parallel.comm``); ``parallel.pipeline.Part`` is what one rank runs.

Each rank's device is explicit: ``cuda:<rank % cards>`` by default on a
machine with cards, or what the caller passes (``cpu`` in the tests; one
card shared by every rank under gloo in the smoke run).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from fastkv_tpu_torch.cache.kv_cache import KVCache
from fastkv_tpu_torch.core.config import ModelConfig, ParallelConfig
from fastkv_tpu_torch.core.device import resolve_device

# the mesh's axes in the JAX package's device order ('expert' is a stub of
# size 1 that no spec names)
AXES = ("data", "model", "seq", "pipe")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on the data x model x seq x pipe mesh and the groups
    it talks over: for each axis the group of ranks that differ from this one
    only along it (global ranks in the axis's order) and this rank's index."""

    pcfg: ParallelConfig
    rank: int  # global rank
    device: torch.device
    data_index: int  # which data replica
    seq_index: int  # which slice of the sequence
    seq_group: object
    seq_ranks: Tuple[int, ...]
    data_group: object
    data_ranks: Tuple[int, ...]
    model_index: int = 0  # which slice of the heads and MLP columns
    model_group: object = None
    model_ranks: Tuple[int, ...] = ()
    pipe_index: int = 0  # which stage of the layers
    pipe_group: object = None
    pipe_ranks: Tuple[int, ...] = ()

    @property
    def seq(self) -> int:
        return self.pcfg.seq

    @property
    def data(self) -> int:
        return self.pcfg.data

    @property
    def model(self) -> int:
        return self.pcfg.model

    @property
    def pipe(self) -> int:
        return self.pcfg.pipe

    @property
    def place(self) -> Dict[str, int]:
        """This rank's index along each axis."""
        return {axis: getattr(self, f"{axis}_index") for axis in AXES}

    def batch_rows(self, b: int) -> slice:
        """The rows of a batch of ``b`` that this rank's data replica runs."""
        if b % self.data:
            raise ValueError(f"batch {b} does not split over {self.data} data replicas")
        n = b // self.data
        return slice(self.data_index * n, (self.data_index + 1) * n)


def rank_grid(pcfg: ParallelConfig) -> np.ndarray:
    """The global rank at each (data, model, seq, pipe) place: the JAX
    package's device order (``make_mesh``'s reshape)."""
    return np.arange(pcfg.num_devices).reshape(pcfg.data, pcfg.model, pcfg.seq, pcfg.pipe)


def make_mesh(pcfg: ParallelConfig, device: Optional[object] = None) -> Mesh:
    """The mesh over the ranks of the default process group, whose size must
    be ``pcfg.num_devices``. Every rank calls it, in the same order as any
    other group creation (``dist.new_group`` is collective)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed process group")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != pcfg.num_devices:
        raise ValueError(f"the process group has {world} ranks, the mesh {pcfg.num_devices}")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run the mesh on "
                               "the CPU")
        device = f"cuda:{rank % torch.cuda.device_count()}"
    dev = resolve_device(device)
    grid = rank_grid(pcfg)
    place = [int(i) for i in np.argwhere(grid == rank)[0]]
    fields: Dict[str, Any] = {}
    for ax, name in enumerate(AXES):  # every rank creates every group, in one order
        lines = np.moveaxis(grid, ax, -1).reshape(-1, grid.shape[ax])
        for line in lines:
            ranks = tuple(int(r) for r in line)
            g = dist.new_group(list(ranks))
            if rank in ranks:
                fields.update({f"{name}_group": g, f"{name}_ranks": ranks,
                               f"{name}_index": place[ax]})
    return Mesh(pcfg=pcfg, rank=rank, device=dev, **fields)


# ---------------------------------------------------------------------------
# The placements (JAX sharding.py:51-140)
# ---------------------------------------------------------------------------

Spec = Tuple[Optional[str], ...]


def param_pspecs(cfg: ModelConfig) -> Dict[str, Any]:
    """The axis each dim of each weight splits over (JAX ``param_pspecs``)."""
    col, row, norm = ("pipe", None, "model"), ("pipe", "model", None), ("pipe",)
    return {
        "embed": (),
        "final_norm": (),
        "layers": {"wq": col, "wk": col, "wv": col, "wo": row, "w_gate": col, "w_up": col,
                   "w_down": row, "ln_attn": norm, "ln_mlp": norm},
    }


def lm_head_pspec() -> Spec:
    return (None, "model")


def full_param_pspecs(cfg: ModelConfig, tie: Optional[bool] = None,
                      quantized: bool = False) -> Dict[str, Any]:
    """``param_pspecs`` with the untied head and, with ``quantized``, the
    int8 ``<name>_scale`` leaves: a column-parallel weight's scales split on
    ``model`` with it, a row-parallel weight's are replicated."""
    specs = param_pspecs(cfg)
    if quantized:
        lay = specs["layers"]
        for name in ("wq", "wk", "wv", "w_gate", "w_up"):
            lay[name + "_scale"] = ("pipe", None, "model")
        for name in ("wo", "w_down"):
            lay[name + "_scale"] = ("pipe",)
        specs["embed_scale"] = ()
    if not (cfg.tie_word_embeddings if tie is None else tie):
        specs["lm_head"] = lm_head_pspec()
        if quantized:
            specs["lm_head_scale"] = (None, "model")
    return specs


def cache_pspec(quantized: bool = False) -> KVCache:
    """The cache's placement: its layer axis on ``pipe`` (a stage-local
    cache), the batch on ``data``, the cache heads on ``model``."""
    scale = ("pipe", "data", "model", None) if quantized else None
    return KVCache(k=("pipe", "data", "model", None, None), v=("pipe", "data", "model", None, None),
                   pos=("pipe", "data", "model", None), valid=("pipe", "data", "model", None),
                   k_scale=scale, v_scale=scale)


def slices(shape: Tuple[int, ...], spec: Spec, pcfg: ParallelConfig,
           place: Dict[str, int]) -> Tuple[slice, ...]:
    """The slice of each dim of a leaf of ``shape`` placed by ``spec`` that
    the rank at ``place`` (``Mesh.place``) holds. A split axis must divide
    its dim (``ParallelConfig.check_model`` says so for a model's leaves)."""
    out = []
    for d, n in enumerate(shape):
        axis = spec[d] if d < len(spec) else None
        if axis is None:
            out.append(slice(0, n))
            continue
        ways = getattr(pcfg, axis)
        if n % ways:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split over {axis}={ways}")
        i, w = place[axis], n // ways
        out.append(slice(i * w, (i + 1) * w))
    return tuple(out)


def shard(t: torch.Tensor, spec: Spec, pcfg: ParallelConfig,
          place: Dict[str, int]) -> torch.Tensor:
    """The slice of ``t`` the rank at ``place`` holds: ``t`` itself where
    nothing splits, else a copy of the slice (the whole can then be freed)."""
    sl = slices(tuple(t.shape), spec, pcfg, place)
    if all(s.start == 0 and s.stop == n for s, n in zip(sl, t.shape)):
        return t
    return t[sl].clone()


def params_specs(params: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """The specs of the leaves ``params`` holds: int8 detected by its
    ``_scale`` siblings, the head untied where an ``lm_head`` is present, and
    the optional embedding and head scales only where they exist
    (``quantize_params_int8(quantize_embed=False)`` leaves them out)."""
    quantized = any(k.endswith("_scale") for k in params.get("layers", {}))
    specs = full_param_pspecs(cfg, tie="lm_head" not in params, quantized=quantized)
    for opt in ("embed_scale", "lm_head_scale"):
        if opt in specs and opt not in params:
            del specs[opt]
    return specs


def shard_params(params: Dict[str, Any], mesh: Mesh, cfg: ModelConfig) -> Dict[str, Any]:
    """This rank's slices of a whole params tree (any device), by the specs
    of the leaves it holds."""
    mesh.pcfg.check_model(cfg)
    specs = params_specs(params, cfg)
    out: Dict[str, Any] = {"layers": {}}
    for k, v in params.items():
        if k != "layers":
            out[k] = shard(v, specs[k], mesh.pcfg, mesh.place)
    for k, v in params["layers"].items():
        out["layers"][k] = shard(v, specs["layers"][k], mesh.pcfg, mesh.place)
    return out
