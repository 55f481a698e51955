"""A short check and timing of the decode kernel on one card, for a first call
after a change to it and for comparing two checkouts in one call.

    python3 -m fastkv_tpu_torch.kernels.decode_probe            # this checkout
    python3 fastkv_tpu_torch/kernels/decode_probe.py --root DIR --tag parent

``--root`` imports the port from another checkout (an unpacked parent
commit), so that running parent, change, change, parent in one call compares
two versions on the same card; everything goes through the public wrapper
``ops.decode_attn.decode_attention``, whose contract both keep. It builds
``decode_attn``, prints the ptxas register lines of its instantiations and
those that spill, holds every form to its float32 plain version
(``kernels/agreement.py``) at small edge shapes (query groups of 1, 4, 8 and
10 by ragged C of 1, 63, 777 and 8320 over a bf16 and an int8 cache, a cache
head and a whole example with no visible slot, runs of fully invalid tiles,
the broadcast [b, C] mask, per-example masks at b = 4, int8, the window
term, d = 64), then checks and times each main-path form
at Llama-3.1-8B / Ministral-8B width against one sdpa call beside it: FastKV
b=1 C=1032, SnapKV b=4 (CH = H = 32), FullKV C=8320, Ministral's FullKV cache
rank-cut to 32768 of 41088 slots, the window term on that cache, and the
int8 cache at C=1032 and 8320. Times are device ms per call from CUDA
graphs of 4 L calls (``timing.graph_ms``, as ``chip_smoke.py`` takes them),
the kernel and sdpa each cycling over the same L layers, enough that each
call reads its cache from device memory. One JSON line. Not part of
``chip_smoke.py``, whose numbers are the ones the records keep.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", help="checkout to import the port from (default: this one)")
    ap.add_argument("--tag", default="", help="label of the output line")
    args = ap.parse_args(argv)
    if args.root:
        sys.path.insert(0, args.root)
    import torch

    if not torch.cuda.is_available():
        print("decode_probe: no CUDA device is available", file=sys.stderr)
        return 2
    from fastkv_tpu_torch.core import quant
    from fastkv_tpu_torch.engine.decode import window_mask
    from fastkv_tpu_torch.kernels import agreement, build, timing
    from fastkv_tpu_torch.ops import decode_attn as da

    t0 = time.time()
    build.load("decode_attn", da.bind)
    log = build.build_log("decode_attn")
    spills = [name for name, v in timing.ptxas_spills(log).items() if v != [0, 0]]
    res = {"tag": args.tag, "port": da.__file__, "build_s": time.time() - t0,
           "registers": [ln.strip() for ln in log.splitlines() if "registers" in ln],
           "spilling": spills, "gpu": torch.cuda.get_device_name(0)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, dev = torch.bfloat16, "cuda"

    def cache(L, b, CH, C, d, n_kept, dtype=bf16, decoded=31):
        """L layers: n_kept slots scattered over the first C - 128 (all of
        them if n_kept covers them), then ``decoded`` decode slots."""
        k = torch.randn((L, b, CH, C, d), generator=gen, device=dev).to(dtype)
        v = torch.randn((L, b, CH, C, d), generator=gen, device=dev).to(dtype)
        cap = max(C - 128, 0)
        valid = torch.zeros((L, b, CH, C), dtype=torch.bool, device=dev)
        if n_kept >= cap:
            valid[..., :cap] = True
        else:
            keys = torch.rand((L, b, CH, cap), generator=gen, device=dev)
            valid[..., :cap] = keys.argsort(-1).argsort(-1) < n_kept
        valid[..., cap:cap + decoded] = True
        return k, v, valid

    def check(name, q, k, v, valid, **kw):
        out = da.decode_attention(q, k, v, valid, **kw)
        ref = da.decode_attention_plain(q.float(), k if k.dtype == torch.int8 else k.float(),
                                        v if v.dtype == torch.int8 else v.float(), valid, **kw)
        r = agreement.compare(out, ref, agreement.TOLERANCES[out.dtype])
        agree[name] = {key: r[key] for key in ("ok", "max_row_rel_rms", "max_elem_rel",
                                                "rows_seeing_no_key")}
        return out

    agree = {}
    for g in (1, 4, 8, 10):
        for C in (1, 63, 777, 8320):
            q = torch.randn((2, 2 * g, 1, 128), generator=gen, device=dev).to(bf16)
            k, v, valid = cache(1, 2, 2, C, 128, C // 2)
            check(f"g{g}_C{C}", q, k[0], v[0], valid[0])
            ki, ks = quant.quantize_kv(k[0])
            vi, vs = quant.quantize_kv(v[0])
            check(f"int8_g{g}_C{C}", q, ki, vi, valid[0], k_scale=ks, v_scale=vs)
    q = torch.randn((3, 8, 1, 128), generator=gen, device=dev).to(bf16)
    k, v, valid = cache(1, 3, 2, 4000, 128, 1000)
    valid[0, 1, 1] = False  # a cache head with no visible slot
    valid[0, 2] = False  # a whole example with none
    valid[0, 0, :, 200:3000] = False  # runs of fully invalid tiles
    out = check("empty_head_example_and_runs", q, k[0], v[0], valid[0])
    agree["empty_exactly_zero"] = {"ok": bool((out[1, 4:] == 0).all() and
                                              (out[2] == 0).all())}
    check("broadcast_b_C_mask", q, k[0], v[0], valid[0][:, 0])
    q4 = torch.randn((4, 32, 1, 128), generator=gen, device=dev).to(bf16)
    k4, v4, valid4 = cache(1, 4, 8, 1032, 128, 896)
    valid4[0, 3, :, 500:] = False  # per-example masks, one much shorter
    check("b4_per_example", q4, k4[0], v4[0], valid4[0])
    ki, ks = quant.quantize_kv(k4[0])
    vi, vs = quant.quantize_kv(v4[0])
    check("int8_b4", q4, ki, vi, valid4[0], k_scale=ks, v_scale=vs)
    kpos = torch.sort(torch.randint(0, 1500, k4[0].shape[:3], generator=gen, device=dev),
                      dim=-1).values.to(torch.int32)
    qpos = torch.tensor([1500, 1200, 900, 1500], dtype=torch.int32, device=dev)
    check("window_b4", q4, k4[0], v4[0], valid4[0], q_pos=qpos, k_pos=kpos,
          sliding_window=300)
    check("window_int8_b4", q4, ki, vi, valid4[0], q_pos=qpos, k_pos=kpos,
          sliding_window=300, k_scale=ks, v_scale=vs)
    q64 = torch.randn((2, 8, 1, 64), generator=gen, device=dev).to(bf16)
    for C in (63, 1000):
        k, v, valid = cache(1, 2, 2, C, 64, C // 3)
        check(f"d64_C{C}", q64, k[0], v[0], valid[0])
        ki, ks = quant.quantize_kv(k[0])
        vi, vs = quant.quantize_kv(v[0])
        check(f"d64_int8_C{C}", q64, ki, vi, valid[0], k_scale=ks, v_scale=vs)
    del k, v, valid, k4, v4, valid4, ki, vi
    res["agree"] = agree

    def timed(name, L, b, H, CH, C, n_kept, rank_cut=None, window=None, int8=False):
        q = torch.randn((b, H, 1, 128), generator=gen, device=dev).to(bf16)
        k, v, valid = cache(L, b, CH, C, 128, n_kept)
        attend = valid if rank_cut is None else torch.stack(
            [window_mask(valid[l], rank_cut) for l in range(L)])
        kw = [dict() for _ in range(L)]
        seen_all = attend
        if window is not None:
            kpos = torch.arange(C, dtype=torch.int32, device=dev).expand(b, CH, C).contiguous()
            qpos = torch.full((b,), C - 128 + 31, dtype=torch.int32, device=dev)
            for l in range(L):
                kw[l] = dict(q_pos=qpos, k_pos=kpos, sliding_window=window)
            seen_all = attend & (kpos > qpos[:, None, None] - window)[None]
        if int8:
            ki, ks = quant.quantize_kv(k)
            vi, vs = quant.quantize_kv(v)
            k, v = ki, vi
            for l in range(L):
                kw[l] = dict(k_scale=ks[l], v_scale=vs[l])
        seen = seen_all[0]
        check(name, q, k[0], v[0], attend[0], **kw[0])
        layers = itertools.cycle(range(L))

        def kern():
            l = next(layers)
            da.decode_attention(q, k[l], v[l], attend[l], **kw[l])

        ms = timing.graph_ms(kern, 4 * L)
        n_seen = int(seen.sum())
        nbytes = (k.element_size() * 2 * n_seen * 128 + 4 * q.numel() + attend[0].numel()
                  + (8 * n_seen if int8 else 0))
        row = {"device_ms": ms, "bound_ms": nbytes / timing.PEAK_BYTES * 1e3,
               "visible_slots": n_seen}
        row["bound_share"] = row["bound_ms"] / ms
        if not int8:
            masks = seen_all[:, :, :, None, :].repeat_interleave(H // CH, dim=2)
            row["sdpa_device_ms"] = timing.graph_ms(timing.layer_sdpa(q, k, v, masks), 4 * L)
        res["times"][name] = row
        del q, k, v, valid, attend

    res["times"] = {}
    timed("fastkv_C1032", 32, 1, 32, 8, 1032, 896)
    timed("int8_C1032", 32, 1, 32, 8, 1032, 896, int8=True)
    timed("snapkv_b4", 4, 4, 32, 32, 1032, 896)
    timed("fullkv_C8320", 4, 1, 32, 8, 8320, 8192)
    timed("int8_C8320", 4, 1, 32, 8, 8320, 8192, int8=True)
    timed("ministral_rank_cut_C41088", 2, 1, 32, 8, 40960 + 128, 40960, rank_cut=32768)
    timed("window_term_C41088", 2, 1, 32, 8, 40960 + 128, 40960, window=32768)
    res["seconds"] = time.time() - t0
    print(json.dumps(res), flush=True)
    return 0 if all(a["ok"] for a in agree.values()) and not spills else 1


if __name__ == "__main__":
    sys.exit(main())
