"""What one rank runs of a model split over a mesh, and the pipeline's walk
over the layer stages.

The JAX package leaves both to its partitioner: a leaf sharded on ``model``
makes XLA run each device's heads and insert the sums, a layer axis sharded
on ``pipe`` makes it move the hidden state between the stages. Here a rank
runs ``Part``:

  * ``cfg``: the model's config over this rank's slice of the heads, kv
    heads and MLP columns (``num_heads / model``, ``num_kv_heads / model``,
    ``intermediate_size / model``; every other field the model's, the layer
    count and the vocabulary included), so the code that sizes a layer, a
    cache plane or a scratch buffer from a config sizes it by the local
    heads;
  * ``lo``, ``hi``: its stage's layers; the stage's weights and cache hold
    layers [lo, hi) at indices [0, hi - lo);
  * ``tp``: the model group the row-parallel products, an untied head's
    vocabulary and the few cross-head sums go over (None when model = 1).

``run_layers`` walks layers [a, b) over the stages: each stage runs those it
holds and hands the state (a tuple of tensors, with whatever shapes it has
at that layer: ``comm.send`` carries them) to the next; ``share`` gives the
result of one stage to every stage (the last stage's logits, so every rank
returns the same logits and picks the same tokens). With no mesh, or pipe =
1, both reduce to the plain loop.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import torch

from fastkv_tpu_torch.core.config import ModelConfig
from fastkv_tpu_torch.parallel import comm


@dataclasses.dataclass(frozen=True)
class Part:
    """One rank's share of the model (see the module docstring)."""

    cfg: ModelConfig  # over this rank's heads and MLP columns
    lo: int  # this stage's layers: [lo, hi)
    hi: int
    mesh: Optional[object] = None  # parallel.sharding.Mesh

    @property
    def tp(self):
        """The model group, or None when nothing splits on ``model``."""
        return self.mesh.model_group if self.mesh is not None and self.mesh.model > 1 else None

    @property
    def pipe(self) -> int:
        return 1 if self.mesh is None else self.mesh.pipe

    @property
    def stage(self) -> int:
        return 0 if self.mesh is None else self.mesh.pipe_index

    @property
    def num_layers(self) -> int:
        """The layers this stage holds."""
        return self.hi - self.lo

    def stage_of(self, layer: int) -> int:
        """The stage that holds ``layer``."""
        return layer // (self.cfg.num_layers // self.pipe)

    def share(self, stage: int, tensors: Optional[Sequence[torch.Tensor]],
              device) -> List[torch.Tensor]:
        """``tensors`` of ``stage`` (None on the other stages) on every stage."""
        if self.pipe == 1:
            return list(tensors)
        m = self.mesh
        return comm.broadcast(tensors, m.pipe_ranks[stage], m.pipe_group, device)


def part(cfg: ModelConfig, mesh=None) -> Part:
    """This rank's ``Part`` of ``cfg`` over ``mesh`` (the whole model
    without one)."""
    L = cfg.num_layers
    if mesh is None:
        return Part(cfg, 0, L)
    mesh.pcfg.check_model(cfg)
    m, p = mesh.model, mesh.pipe
    local = cfg if m == 1 else dataclasses.replace(
        cfg, num_heads=cfg.num_heads // m, num_kv_heads=cfg.num_kv_heads // m,
        intermediate_size=cfg.intermediate_size // m)
    n = L // p
    return Part(local, mesh.pipe_index * n, (mesh.pipe_index + 1) * n, mesh)


def run_layers(p: Part, a: int, b: int, state, body: Callable, make: Optional[Callable] = None):
    """Layers [a, b) through ``body(state, l) -> state`` (``l`` the model's
    layer index), each on the stage that holds it. ``state`` is a tuple of
    tensors (``make(*tensors)`` rebuilds one received, a NamedTuple's class;
    default a plain tuple); on entry the stage
    that holds layer a - 1 (the first stage for a = 0) holds it, the other
    stages may pass None. A stage that runs layers receives the state from
    the previous stage unless it held it on entry, and sends it on unless the
    next stage runs nothing of [a, b). Returns the state after layer b - 1 on
    the stage that holds that layer (for a = b, the state on entry), None on
    the others."""
    if p.pipe == 1:
        for l in range(a, b):
            state = body(state, l)
        return state
    m, me = p.mesh, p.stage
    holder_in = p.stage_of(a - 1) if a > 0 else 0
    holder_out = p.stage_of(b - 1) if b > a else holder_in
    start, stop = max(a, p.lo), min(b, p.hi)
    if start < stop:
        if me != holder_in:
            got = comm.recv(m.pipe_ranks[me - 1], m.pipe_group, m.device)
            state = tuple(got) if make is None else make(*got)
        for l in range(start, stop):
            state = body(state, l)
    elif me != holder_in:
        return None
    if me == holder_out:
        return state
    comm.send(list(state), m.pipe_ranks[me + 1], m.pipe_group)
    return None
