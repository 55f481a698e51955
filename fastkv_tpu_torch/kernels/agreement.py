"""How close a kernel's output must lie to its plain version's.

The reference is the plain version run in float32 on float32 copies of the
kernel's inputs, so it carries no rounding of its own. An attention output is
compared row by row (one row = the d values of one query head and query), at
the scale of that row, because the output's magnitude falls with the number of
keys a row sees: at s = 8192 a typical |out| is ~0.02, far below the |out| ~ 1
of the first rows. A bound set by the largest outputs would let a dropped key
tile through in the small ones.

Two limits per dtype:
  * ``row``: rms(out - ref) <= row * rms(ref) for every row; a row whose
    reference is all 0 (it sees no key) must be exactly 0. Dropping k of a
    row's n (roughly equally weighted) keys moves it by about sqrt(k / n) of
    its rms: a 64-key tile of 8192 keys is ~9%, a 32-slot decode chunk ~6%.
  * ``elem``: |out - ref| <= elem * max(|ref|, rms(ref row)) for every
    element, which catches one wrong lane that a row's rms would dilute.

bfloat16: the kernels round their output to bf16 (at most 2^-8 of |x|) and
round the unnormalised probabilities to bf16 before P.V, as the TPU kernels
cast P to V's dtype (each p loses at most 2^-9 of itself, and the losses add
with random signs: a spread of ~2^-9 / sqrt(3) ~ 1.1e-3 of the row's rms).
Together ~2e-3 of a row's rms; ``row`` = 1e-2 leaves 5x and still rejects a
dropped tile or chunk. Per element the noise is at most 2^-8 from the output
rounding plus ~5.7 spreads of the P term at the largest of 10^7 elements,
~1e-2 of the scale; ``elem`` = 2^-5 leaves 3x.
float32: only the order of summation differs, ~1e-6 relative.

Row statistics (the flash kernel's ``(m, l)``, float32 whatever the inputs'
dtype) are held per row by ``compare_stats``: |m - m_ref| <= m *
max(1, |m_ref|) and |l - l_ref| <= l * l_ref, and a row that sees no key
must give exactly m = -1e30 and l = 0. Both sides multiply the same input
values exactly (bf16 products are exact in float32); what differs is the
order of the d-term sums behind each logit (~1e-7 of the ~100 of summed
|terms| at d = 128, random inputs: ~2e-6 of a logit once scaled), the
exp2 of the bf16 kernel's prescaled logits and its conversion of m from
log2 units (~1e-7 each). So m and l agree to a few 1e-6; ``STATS`` = 1e-4
leaves >10x, while one 128-key tile dropped from a 4096-key chunk moves l by
~3%.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch


class Tolerance(NamedTuple):
    row: float
    elem: float


TOLERANCES: Dict[torch.dtype, Tolerance] = {
    torch.bfloat16: Tolerance(row=1e-2, elem=2.0 ** -5),
    torch.float32: Tolerance(row=1e-4, elem=1e-3),
}


class StatsTolerance(NamedTuple):
    m: float
    l: float


STATS = StatsTolerance(m=1e-4, l=1e-4)
NO_KEY_M = -1e30  # m of a row that sees no key


def compare_stats(m: torch.Tensor, l: torch.Tensor, m_ref: torch.Tensor, l_ref: torch.Tensor,
                  tol: StatsTolerance = STATS) -> Dict[str, object]:
    """Hold the row statistics (m, l) [..., rows] float32 against the plain
    version's. Returns the readings, the limits and ``ok``."""
    m, l, m_ref, l_ref = (x.float().reshape(-1) for x in (m, l, m_ref, l_ref))
    seen = l_ref > 0
    m_rel = torch.where(seen, (m - m_ref).abs() / torch.clamp(m_ref.abs(), min=1.0), 0.0)
    l_rel = torch.where(seen, (l - l_ref).abs() / torch.where(seen, l_ref, 1.0), 0.0)
    unseen_exact = bool(((m[~seen] == NO_KEY_M) & (l[~seen] == 0)).all())
    finite = bool(torch.isfinite(m).all() and torch.isfinite(l).all())
    r = {
        "max_abs_err_m": (m - m_ref)[seen].abs().max().item() if bool(seen.any()) else 0.0,
        "max_m_rel": m_rel.max().item(),
        "max_l_rel": l_rel.max().item(),
        "rows_seeing_no_key": int((~seen).sum()),
        "tol_m": tol.m,
        "tol_l": tol.l,
    }
    r["ok"] = finite and unseen_exact and r["max_m_rel"] <= tol.m and r["max_l_rel"] <= tol.l
    return r


def compare(out: torch.Tensor, ref: torch.Tensor, tol: Tolerance) -> Dict[str, object]:
    """Hold ``out`` against ``ref`` (same shape, last axis = a row). Returns
    the readings, the limits and ``ok``."""
    out = out.float().reshape(-1, out.shape[-1])
    ref = ref.float().reshape(-1, ref.shape[-1])
    err = out - ref
    ref_rms = ref.square().mean(dim=-1).sqrt()
    err_rms = err.square().mean(dim=-1).sqrt()
    seen = ref_rms > 0
    row_rel = torch.where(seen, err_rms / torch.where(seen, ref_rms, 1.0), 0.0)
    scale = torch.maximum(ref.abs(), ref_rms[:, None])
    elem_rel = torch.where(scale > 0, err.abs() / torch.where(scale > 0, scale, 1.0), 0.0)
    unseen_exact = bool((err_rms[~seen] == 0).all())
    finite = bool(torch.isfinite(out).all())
    r = {
        "max_abs_err": err.abs().max().item(),
        "max_row_rel_rms": row_rel.max().item(),
        "median_row_rel_rms": row_rel[seen].median().item() if bool(seen.any()) else 0.0,
        "max_elem_rel": elem_rel.max().item(),
        "median_ref_row_rms": ref_rms[seen].median().item() if bool(seen.any()) else 0.0,
        "rows_seeing_no_key": int((~seen).sum()),
        "tol_row": tol.row,
        "tol_elem": tol.elem,
    }
    r["ok"] = (finite and unseen_exact and r["max_row_rel_rms"] <= tol.row
               and r["max_elem_rel"] <= tol.elem)
    return r
