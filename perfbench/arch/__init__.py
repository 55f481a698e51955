"""Architecture modules: what the harness knows of a model's shape.

A configuration file's ``reference`` key names its architecture: the plain
reference ``perfbench/reference/<name>.py`` and the module
``perfbench/arch/<name>.py``, which ``load`` finds by that name. Outside
these two, no file of the harness reads a key of the model's shape (the
number of layers apart). An architecture module exports:

  * ``make_weights(m, seed, device, dtype)``: the weights of the model ``m``
    (the configuration's ``model`` dict) from the seed, on the device, in
    the served dtype, laid out as the program takes them;
  * ``cache_rows(m)``: the rows one token adds to a layer's cache, one for
    each cache head (``valid`` and ``pos`` hold one plane per cache head);
  * ``prefill_flops(m, method, n)``: FLOPs a prefill of n true tokens needs;
  * ``flash_calls(m, method, n)``: (FLOP, bytes) of each layer's prefill
    attention call;
  * ``decode_attn_bytes(m, live, batch=1)``: bytes one decode-attention
    call moves, ``live`` the visible slots of each cache head and example;
  * ``decode_step_work(m, live_per_layer, batch=1)``: (FLOP, bytes) of one
    decode step, ``live_per_layer`` the visible slots of each layer summed
    over its cache heads and the batch.

Each module counts its own layers, so layers of different kinds (a dense
first layer, then experts of which a token uses a few) and a query/key width
other than the value width are the module's business; ``perfbench.work``
dispatches to it and keeps what no architecture shapes (peaks, budgets,
segment lengths, shares).
"""

from __future__ import annotations

import importlib
from types import ModuleType


def load(name: str) -> ModuleType:
    """The architecture module ``name`` (a configuration's ``reference``)."""
    return importlib.import_module(f"{__name__}.{name}")
