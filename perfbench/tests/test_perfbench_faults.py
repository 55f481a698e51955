"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped (``run.run(device="cpu")``) and the
rest of a run is driven on the tiny cells, with one of ``perfbench.faults``
planted in the program's decode step (a token altered where it is produced,
a step that returns its state unchanged, half of the batch left out: the
open cell's Scheduler decodes four slots)."""

import pytest
import torch

from perfbench import faults, run
from perfbench.tests import cells


@pytest.mark.parametrize("cell,fault", [
    ("tiny-closed", "altered_token"), ("tiny-closed", "state_unchanged"),
    ("tiny-open", "altered_token"), ("tiny-open", "state_unchanged"),
    ("tiny-open", "half_batch")])
def test_fault_is_not_correct(tmp_path, cell, fault):
    root = cells.write(tmp_path)
    with faults.planted(fault):
        res = run.run(root, cell, 2**32 + 3, 1.5, False, device="cpu", log=lambda m: None)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_sound_run_is_correct(tmp_path):
    root = cells.write(tmp_path)
    res = run.run(root, "tiny-open", 2**32 + 3, 1.5, False, device="cpu", log=lambda m: None)
    assert res["correct"] is True, res["checks"]
    assert torch.is_grad_enabled()


def test_unchanged_state_shows_in_the_cache(tmp_path):
    """Over a few new tokens a step that keeps nothing barely moves the
    logits (the prefill cell's 8 tokens over thousands of kept slots a head
    read a gap of 0.004 on the card); the closed loop's cache after its last
    step shows every decoded token missing, where a sound run misses none."""
    root = cells.write(tmp_path)
    with faults.planted("state_unchanged"):
        res = run.run(root, "tiny-closed", 2**32 + 5, 1.5, False, device="cpu",
                      log=lambda m: None)
    assert res["checks"]["decode_misses"]["value"] > 0
    res = run.run(root, "tiny-closed", 2**32 + 5, 1.5, False, device="cpu", log=lambda m: None)
    assert res["checks"]["decode_misses"]["value"] == 0 and res["correct"] is True
