"""The numbers that decide ``correct`` and their limits.

From the program's readings of the compared steps and the reference's:

* ``batch_mismatch``: elements of the first device batch that differ from
  the reference's own assembly (exact: limit 0);
* ``loss_gap``: the largest |L − L_ref| / |L_ref| over the compared steps;
* ``emb_gap.<encoder>``: the largest L2 distance between a sample's
  embedding and the reference's at the first step (both unit vectors);
* ``grad_gap``: the first gradient as Adam holds it, by the worst leaf
  of two or more dimensions: |‖g‖ − ‖g_ref‖| / max(‖g_ref‖, the median
  such leaf's ‖g_ref‖). The vectors (BatchNorm scales and shifts, biases)
  are left out: their gradients are sums over the whole batch that cancel
  to a few % of their terms, and bfloat16 compute moves their norms by
  5-20% on every seed (PERF.md); their change is still compared;
* ``change_gap``: the change over the compared steps of every leaf and
  running statistic, by the worst one, measured the same way. A leaf whose
  reference gradient is below a thousandth of the median leaf's moves
  under Adam by rounding alone and is left out.

A cell's limits are in ``limits/<cell>.json``, each set between the
program's largest reading over a dozen seeds and the smallest reading of
the control or of a planted fault (PERF.md). A number without a limit
fails.
"""

from __future__ import annotations

import math
import statistics

NOUGHT = 1e-3  # of the median leaf's reference gradient


def worst_leaf(prog: dict, ref: dict, names) -> float:
    names = list(names)
    median = statistics.median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], median) for n in names)


def matrices(ref: dict) -> list:
    """The leaves of two or more dimensions: weight matrices, kernels and
    the embedding."""
    return [n for n in ref["grad"] if ref["ndim"][n] >= 2]


def numbers(prog: dict, ref: dict) -> dict:
    out = {"loss_gap": max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))}
    for key, want in ref["emb"].items():
        got = prog["emb"].get(key)
        # Rows that are missing or extra: the largest distance of unit vectors.
        same = got is not None and got.shape == want.shape
        out[f"emb_gap.{key}"] = float((got - want).norm(dim=1).max()) if same else 2.0
    out["grad_gap"] = worst_leaf(prog["grad"], ref["grad"], matrices(ref))
    median = statistics.median(ref["grad_abs"].values())
    kept = [n for n in ref["change"] if ref["grad_abs"].get(n, median) >= NOUGHT * median]
    out["change_gap"] = worst_leaf(prog["change"], ref["change"], kept)
    return out


def judge(found: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}); every number must be at or
    under its limit, and a number without one, or not finite (shown as
    null), fails."""
    table = limits.get("numbers", {})
    checks, ok = {}, True
    for name, value in found.items():
        limit = table.get(name, {}).get("limit")
        finite = math.isfinite(value)
        checks[name] = {"value": value if finite else None, "limit": limit}
        ok = ok and limit is not None and finite and value <= limit
    return ok, checks
