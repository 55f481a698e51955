"""A short check and timing of the flash kernel on one card, for a first call
after a change to it and for comparing two checkouts in one call.

    python3 -m fastkv_tpu_torch.kernels.flash_probe            # this checkout
    python3 fastkv_tpu_torch/kernels/flash_probe.py --root DIR --tag parent

``--root`` imports the port from another checkout (an unpacked parent
commit, of this script's version or later: the finishing pass's entry point
changed with it), so that running parent, change, change, parent in one call
compares two versions on the same card. It builds ``flash_prefill``, prints the
instantiations whose ptxas report shows spills, holds the bf16 kernel to its
float32 plain version (``kernels/agreement.py``) at small shapes in each form
(square ragged, under a window with scattered positions, rectangular with a
gate inside the chunk, fused scores with W = 70 under a window), then times
by CUDA events, at Llama-3.1-8B width: the square form at s = 8192, the fused
form (W = 8, with its finishing pass), the finishing pass alone (and its two
plain calls), the rectangular 2048-row chunk at 6144 over 8192 slots, and
Ministral-8B's window (s = 40960, W = 32768). One JSON line. Not part of
``chip_smoke.py``, whose numbers are the ones the records keep.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _time_ms(torch, fn, reps, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", help="checkout to import the port from (default: this one)")
    ap.add_argument("--tag", default="", help="label of the output line")
    args = ap.parse_args(argv)
    if args.root:
        sys.path.insert(0, args.root)
    import torch

    if not torch.cuda.is_available():
        print("flash_probe: no CUDA device is available", file=sys.stderr)
        return 2
    from fastkv_tpu_torch.kernels import agreement, build
    from fastkv_tpu_torch.ops import flash_prefill as fp
    from fastkv_tpu_torch.policies.selection import window_indices

    t0 = time.time()
    lib = build.load("flash_prefill", fp.bind)
    spills = [ln.strip() for ln in build.build_log("flash_prefill").splitlines()
              if "spill stores" in ln and not ln.strip().startswith("0 bytes stack frame, 0")]
    res = {"tag": args.tag, "port": fp.__file__, "build_s": time.time() - t0,
           "nonzero_spill_lines": spills, "gpu": torch.cuda.get_device_name(0)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    bf16 = torch.bfloat16

    def inputs(b, H, KH, s, d, count):
        q = torch.randn((b, H, s, d), generator=gen, device="cuda").to(bf16)
        k = torch.randn((b, s, KH, d), generator=gen, device="cuda").to(bf16).transpose(1, 2)
        v = torch.randn((b, s, KH, d), generator=gen, device="cuda").to(bf16).transpose(1, 2)
        pos = torch.arange(s, dtype=torch.int32, device="cuda")[None].repeat(b, 1)
        return q, k, v, pos, torch.tensor(count, dtype=torch.int32, device="cuda")

    def window_rows(q, pos, cnt, W):
        idx, ok = window_indices(cnt - W, W, cnt)
        b, h, _, d = q.shape
        q_win = torch.gather(q, 2, idx[:, None, :, None].expand(b, h, W, d))
        return q_win, torch.where(ok, torch.gather(pos, 1, idx), -1).to(torch.int32).contiguous()

    def agrees(out, ref, dtype=bf16):
        return agreement.compare(out, ref, agreement.TOLERANCES[dtype])["ok"]

    agree = {}
    q, k, v, pos, cnt = inputs(2, 8, 2, 700, 128, [700, 523])
    agree["square"] = agrees(fp.flash_attention(q, k, v, pos, cnt),
                             fp.flash_attention_plain(q.float(), k.float(), v.float(), pos, cnt))
    spos = pos.clone()
    for i, n in enumerate((700, 523)):
        spos[i, :n] = torch.randperm(2100, generator=gen, device="cuda")[:n].sort().values
        spos[i, n:] = 0
    agree["window_scattered"] = agrees(
        fp.flash_attention(q, k, v, spos, cnt, 150),
        fp.flash_attention_plain(q.float(), k.float(), v.float(), spos, cnt, 150))
    q_win, qw_pos = window_rows(q, pos, cnt, 70)
    out, sc = fp.flash_attention(q, k, v, pos, cnt, 150, window_q=q_win, window_q_pos=qw_pos)
    ref, ref_sc = fp.flash_attention_plain(q.float(), k.float(), v.float(), pos, cnt, 150,
                                           window_q=q_win.float(), window_q_pos=qw_pos)
    agree["scores_W70"] = agrees(out, ref) and agrees(sc, ref_sc, torch.float32)
    qr = torch.randn((2, 8, 200, 128), generator=gen, device="cuda").to(bf16)
    kr = torch.randn((2, 2, 1024, 128), generator=gen, device="cuda").to(bf16)
    qpos = (torch.tensor([300, 77], dtype=torch.int32, device="cuda")[:, None]
            + torch.arange(200, dtype=torch.int32, device="cuda")[None])
    kpos = torch.arange(1024, dtype=torch.int32, device="cuda")[None].repeat(2, 1)
    kc = torch.tensor([500, 277], dtype=torch.int32, device="cuda")
    hi = torch.tensor([420, 277], dtype=torch.int32, device="cuda")
    agree["rect_gate_in_chunk"] = agrees(
        fp.flash_attention(qr, kr, kr, qpos, kc, k_positions=kpos, k_count=kc, k_hi=hi),
        fp.flash_attention_plain(qr.float(), kr.float(), kr.float(), qpos, kc, None, kpos, kc, hi))
    res["agree"] = agree
    del q, k, v, qr, kr

    s, W = 8192, 8
    q, k, v, pos, cnt = inputs(1, 32, 8, s, 128, [s])
    q_pos, k_pos = pos.contiguous(), fp.fold_key_validity(pos, cnt).contiguous()
    res["square_ms"] = _time_ms(torch, lambda: fp.launch(lib, q, k, v, q_pos, k_pos, stream), 20)
    q_win, qw_pos = window_rows(q, pos, cnt, W)
    res["fused_ms"] = _time_ms(torch, lambda: fp.launch(lib, q, k, v, q_pos, k_pos, stream, 0,
                                                        None, q_win, qw_pos), 20)
    strip = torch.randn((1, 32, W, s), generator=gen, device="cuda")
    strip = torch.where(k_pos[:, None, None, :] <= qw_pos[:, None, :, None], strip, -torch.inf)
    scores = torch.empty((1, 32, s), device="cuda")
    stats = torch.empty((1, 32, W, 2), device="cuda")
    res["finish_ms"] = _time_ms(torch, lambda: lib.window_scores_finish(
        strip.data_ptr(), stats.data_ptr(), scores.data_ptr(), 1, 32, W, s, stream), 200)
    res["finish_agree"] = agrees(scores, torch.softmax(strip, -1).sum(-2), torch.float32)
    res["finish_plain_ms"] = _time_ms(torch, lambda: torch.softmax(strip, -1).sum(-2), 200)
    del q, k, v, strip

    S, c, start = 8192, 2048, 6144
    qr = torch.randn((1, 32, c, 128), generator=gen, device="cuda").to(bf16)
    kr = torch.randn((1, 8, S, 128), generator=gen, device="cuda").to(bf16)
    qpos = (start + torch.arange(c, dtype=torch.int32, device="cuda"))[None].contiguous()
    kpos = torch.arange(S, dtype=torch.int32, device="cuda")[None].contiguous()
    hi = torch.tensor([S], dtype=torch.int32, device="cuda")
    res["rect_ms"] = _time_ms(torch, lambda: fp.launch(lib, qr, kr, kr, qpos, kpos, stream, 0,
                                                       hi), 20)
    del qr, kr

    s, W = 40960, 32768
    q, k, v, pos, cnt = inputs(1, 32, 8, s, 128, [s])
    q_pos, k_pos = pos.contiguous(), fp.fold_key_validity(pos, cnt).contiguous()
    res["window_ms"] = _time_ms(
        torch, lambda: fp.launch(lib, q, k, v, q_pos, k_pos, stream, W), 3, warmup=1)
    print(json.dumps(res), flush=True)
    return 0 if all(agree.values()) and res["finish_agree"] and not spills else 1


if __name__ == "__main__":
    sys.exit(main())
