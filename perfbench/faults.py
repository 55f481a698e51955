"""Faults planted under the timed path, to show that the check catches them.

Each wraps the program's decode step (``fastkv_tpu_torch.engine.decode.
decode_step``, which ``Engine.generate`` and the ``Scheduler`` both call):

  * ``altered_token``: a token altered where it is produced (every fourth
    step's logits favour another token);
  * ``state_unchanged``: a step that returns its state unchanged (the cache
    restored after the step, so no decoded token is ever kept);
  * ``half_batch``: half of the batch left out (the odd rows' logits
    dropped; a batch of one has no half to leave out).

The cells run on one chip, so there is no exchange between chips to leave
out. The CPU tests plant them in the tiny cells
(``perfbench/tests/test_perfbench_faults.py``); ``perfbench.control
--fault`` plants one at a cell's own size on the card.
"""

from __future__ import annotations

import contextlib


def altered_token(orig):
    calls = []

    def step(*a, **kw):
        logits, cache = orig(*a, **kw)
        calls.append(1)
        if len(calls) % 4 == 3:
            wrong = (logits.argmax(dim=-1) + 1) % logits.shape[-1]
            logits = logits.scatter(1, wrong[:, None], float(logits.max()) + 10.0)
        return logits, cache
    return step


def state_unchanged(orig):
    def step(params, cfg, mcfg, cache, *a, **kw):
        saved = [t.clone() for _, t in cache.fields()]
        logits, cache = orig(params, cfg, mcfg, cache, *a, **kw)
        for (_, t), s in zip(cache.fields(), saved):
            t.copy_(s)
        return logits, cache
    return step


def half_batch(orig):
    def step(*a, **kw):
        logits, cache = orig(*a, **kw)
        if logits.shape[0] > 1:
            logits = logits.clone()
            logits[1::2] = 0.0
        return logits, cache
    return step


FAULTS = {f.__name__: f for f in (altered_token, state_unchanged, half_batch)}


@contextlib.contextmanager
def planted(name: str):
    """The program's decode step replaced by fault ``name`` until the exit."""
    from fastkv_tpu_torch.engine import decode

    orig = decode.decode_step
    decode.decode_step = FAULTS[name](orig)
    try:
        yield
    finally:
        decode.decode_step = orig
