"""The numbers the correctness check compares, and their verdict.

A check is ``{"name", "value", "limit"}``; it holds where the value is a
finite number no greater than its limit. Numbers that a cell reads but
does not compare carry ``"limit": None`` and decide nothing.
"""

from __future__ import annotations

import math
import statistics

import torch


def worst_clip_rel_l2(got, ref) -> float:
    """The largest ``|got - ref| / |ref|`` over the rows (clips) of two
    (N, classes) logit tensors; inf where a row of ``got`` is not finite or
    the shapes differ."""
    got, ref = got.double(), ref.double().to(got.device)
    if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
        return math.inf
    err = (got - ref).norm(dim=1) / ref.norm(dim=1).clamp_min(1e-30)
    return float(err.max())


def leaf_norm_gap(prog: dict, ref: dict, names) -> float:
    """The worst leaf's ``| |prog| - |ref| |`` over the larger of the
    reference leaf's norm and the median reference leaf's norm (some
    leaves are all but zero); inf where a leaf is missing or not
    finite."""
    ref_norms = {n: float(ref[n].double().norm()) for n in names}
    median = statistics.median(ref_norms.values())
    worst = 0.0
    for n in names:
        if n not in prog:
            return math.inf
        p = float(prog[n].double().norm())
        if not math.isfinite(p):
            return math.inf
        worst = max(worst, abs(p - ref_norms[n]) / max(ref_norms[n], median,
                                                       1e-30))
    return worst


def moved_leaves(ref_grads: dict, share=1e-3):
    """The leaves whose reference gradient is at least ``share`` of the
    median leaf's: the others (a gradient nought to rounding) move by
    round-off alone and are left out of the change."""
    norms = {n: float(g.double().norm()) for n, g in ref_grads.items()}
    median = statistics.median(norms.values())
    return [n for n, v in norms.items() if v >= share * median]


def rel_gaps(got, ref) -> float:
    """The largest ``|got - ref| / |ref|`` over paired numbers."""
    if len(got) != len(ref):
        return math.inf
    worst = 0.0
    for a, b in zip(got, ref):
        if not math.isfinite(a):
            return math.inf
        worst = max(worst, abs(a - b) / max(abs(b), 1e-30))
    return worst


def checks(values: dict, limits: dict) -> list:
    """Each number beside its limit (None: read, not compared)."""
    return [{"name": k, "value": v, "limit": limits.get(k)}
            for k, v in values.items()]


def passed(check) -> bool:
    if check["limit"] is None:
        return True
    v = check["value"]
    return isinstance(v, (int, float)) and math.isfinite(v) and (
        v <= check["limit"])
