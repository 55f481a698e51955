"""Sequence-parallel prefill over ``torch.distributed``: the mesh, the
collectives and ring/Ulysses attention."""
