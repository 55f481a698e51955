"""The plain reference against the program on the CPU at a tiny size:
logits at every served position, and the reference's own kept sets and TSP
set, equal the program's (float32 on both sides), with and without a
sliding window that binds in prefill and in decode."""

import dataclasses

import pytest
import torch

from perfbench import check, run
from perfbench.reference import mistral
from perfbench.tests.cells import LIMITS, TINY


def program_and_reference(window, n, bucket, new=10, seed=7):
    from fastkv_tpu_torch.core.config import EngineConfig
    from fastkv_tpu_torch.engine import decode as dm
    from fastkv_tpu_torch.engine import prefill as pm

    conf = {**TINY, "model": {**TINY["model"], "sliding_window": window}}
    cfg, mcfg = run.model_config(conf)
    w = run.make_weights(conf["model"], seed, "cpu", torch.float32)
    ecfg = EngineConfig(prefill_buckets=(bucket,), capacity_align=8)
    shapes = pm.plan_shapes(cfg, mcfg, dataclasses.replace(ecfg, max_new_tokens=new), bucket)
    prompt = torch.Generator().manual_seed(seed)
    prompt = torch.randint(0, 256, (n,), generator=prompt).tolist()
    toks = torch.zeros((1, bucket), dtype=torch.int32)
    toks[0, :n] = torch.tensor(prompt)
    spy = run.Spy(run.Spans())
    try:
        logits, cache = pm.prefill(w, cfg, mcfg, shapes, toks,
                                   torch.tensor([n], dtype=torch.int32), ecfg)
        tsp = spy.last_tsp
    finally:
        spy.close()
    kept = (cache.pos.clone(), cache.valid.clone(), shapes.prefill_capacity)
    rows, served = [logits[0]], [int(logits[0].argmax())]
    n_t = torch.tensor([n], dtype=torch.int32)
    for t in range(new - 1):
        lg, cache = dm.decode_step(w, cfg, mcfg, cache,
                                   torch.tensor([served[-1]], dtype=torch.int32), n_t + t,
                                   shapes.prefill_capacity + t)
        rows.append(lg[0])
        served.append(int(lg[0].argmax()))
    rec = run.Record(0, prompt, new, 0.0, tokens=served, kept=kept, tsp=tsp)
    follow = run.follow_of(rec, mistral)
    ref = mistral.run(w, conf["model"], conf["method"], prompt, served, follow)
    return torch.stack(rows), ref, follow, served, prompt


@pytest.mark.parametrize("window", [None, 48])
@pytest.mark.parametrize("n,bucket", [(300, 512), (500, 512), (77, 128)])
def test_reference_matches_program(window, n, bucket):
    prog, ref, follow, served, prompt = program_and_reference(window, n, bucket)
    assert (ref.logits - prog).abs().max().item() < 1e-4
    win = torch.arange(n - 8, n)
    for l, lay in enumerate(ref.layers):
        for c, own in enumerate(lay.own_keep):
            kept = follow.kept[l][c]
            mine = kept[~torch.isin(kept, win)]
            assert torch.equal(torch.sort(own).values, torch.sort(mine).values)
    assert torch.equal(ref.own_tsp, follow.tsp)
    nums = check.judge(ref, served, len(served), follow.kept, follow.tsp, n, 8)
    assert {k: nums[k] for k in ("logit_gap", "token_misses", "set_misses")} == {
        "logit_gap": 0.0, "token_misses": 0.0, "set_misses": 0.0}
    assert nums["keep_regret"] < 1e-6 and nums["tsp_regret"] < 1e-6


def test_judge_sees_a_wrong_selection():
    """A kept set with its best token swapped for its worst shows as
    regret; one of the wrong size as a miss."""
    _, ref, follow, served, prompt = program_and_reference(None, 500, 512)
    n = len(prompt)
    lay = ref.layers[0]
    sc = lay.scores[0]
    kept = [list(h) for h in follow.kept]
    worst_pos = lay.positions[torch.isfinite(sc)][sc[torch.isfinite(sc)].argmin()]
    best_pos = lay.positions[sc.argmax()]
    k0 = kept[0][0].clone()
    k0[k0 == best_pos] = worst_pos
    kept[0][0] = k0
    nums = check.judge(ref, served, len(served), kept, follow.tsp, n, 8)
    assert nums["keep_regret"] > LIMITS["keep_regret"]
    kept[0][1] = kept[0][1][1:]
    nums = check.judge(ref, served, len(served), kept, follow.tsp, n, 8)
    assert nums["set_misses"] >= 1
