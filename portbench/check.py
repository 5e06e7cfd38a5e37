"""The numbers that decide ``correct``: the program's first three training
steps against the plain reference's (``reference.train_steps``).

  loss        the worst relative gap of the three losses (recon, prob, func)
              over the three steps, in the metric rows the trainer reads back
  loss1       the same at the first step alone (the eager step before the
              capture; no Adam step before it)
  loss23      the same at steps 2 and 3, the first replays of the captured
              step's CUDA graph
  grad        the first step's gradient as Adam holds it (its first moment
              over 1 - beta1), by the worst leaf: | |g_prog| - |g_ref| | over
              the larger of |g_ref| and the median leaf's |g_ref|
  grad_med    the same gap of the median leaf
  grad2       the second step's gradient (the first replay's) as Adam holds
              it: (m2 - beta1 m1) / (1 - beta1) from its first moments after
              steps 1 and 2, by the worst leaf
  grad2_med   the same gap of the median leaf
  change      the parameters' change after the third step, by the worst
              leaf and rank; leaves whose reference gradient is under a
              thousandth of the median leaf's (those the attention's softmax
              cancels, which Adam moves by rounding alone) are left out
  change_med  the same gap of the median leaf, the worst rank's

``limits/<workload>.json`` names the numbers a cell compares and their
limits (the readings they were set from are in PERF.md); the others are
printed beside them. A run is correct when every compared number is at or
under its limit; a number that is not finite fails.
"""
from __future__ import annotations

import math
import statistics

GRAD_FLOOR = 1e-3        # of the median leaf's reference gradient: below it a leaf is left out
NAMES = ("loss", "loss1", "loss23", "grad", "grad_med", "grad2", "grad2_med", "change",
         "change_med")


def _gap(p: float, r: float, scale: float) -> float:
    gap = abs(p - r) / max(scale, 1e-30)
    return gap if math.isfinite(gap) else math.inf


def leaf_gaps(prog: dict, ref: dict, names=None) -> dict:
    """leaf -> | |prog| - |ref| | over the larger of |ref| and the median
    leaf's |ref|, for per-leaf norms."""
    names = list(ref) if names is None else list(names)
    med = statistics.median(ref[n] for n in names)
    return {n: _gap(prog[n], ref[n], max(ref[n], med)) for n in names}


def _worst(gaps: dict) -> tuple[float, str]:
    at = max(gaps, key=lambda n: gaps[n])
    return gaps[at], at


def _median(gaps: dict) -> tuple[float, str]:
    return statistics.median(gaps.values()), f"median of {len(gaps)} leaves"


def moved_leaves(ref_grad: dict) -> list:
    med = statistics.median(ref_grad.values())
    return [n for n, g in ref_grad.items() if g >= GRAD_FLOOR * med]


def numbers(prog_losses, ref_losses, prog_grad: dict, ref_grad: dict, prog_grad2: dict,
            ref_grad2: dict, prog_change: list, ref_change: dict) -> dict:
    """``*_losses``: [3 steps][3 losses]; ``*_grad`` / ``*_grad2``: leaf ->
    norm of the first / second gradient; ``prog_change``: one {leaf: norm
    of the change} per rank; ``ref_change`` likewise for the reference.
    Returns {name: (value, where)}."""
    losses = {f"step {s + 1} {part}": _gap(p, r, abs(r))
              for s, (p_row, r_row) in enumerate(zip(prog_losses, ref_losses))
              for part, p, r in zip(("recon", "prob", "func"), p_row, r_row)}
    grads, grads2 = leaf_gaps(prog_grad, ref_grad), leaf_gaps(prog_grad2, ref_grad2)
    keep = moved_leaves(ref_grad)
    per_rank = [leaf_gaps(pc, ref_change, keep) for pc in prog_change]
    worst = max(((_worst(g), r) for r, g in enumerate(per_rank)), key=lambda x: x[0][0])
    med = max(((_median(g), r) for r, g in enumerate(per_rank)), key=lambda x: x[0][0])
    return {"loss": _worst(losses),
            "loss1": _worst({k: v for k, v in losses.items() if k.startswith("step 1 ")}),
            "loss23": _worst({k: v for k, v in losses.items() if not k.startswith("step 1 ")}),
            "grad": _worst(grads), "grad_med": _median(grads),
            "grad2": _worst(grads2), "grad2_med": _median(grads2),
            "change": (worst[0][0], f"rank {worst[1]} {worst[0][1]}"),
            "change_med": (med[0][0], f"rank {med[1]} {med[0][1]}")}


def judge(nums: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the numbers ``limits``
    names."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = nums[name][0]
        out[name] = {"value": value, "limit": float(limit)}
        ok = ok and math.isfinite(value) and value <= float(limit)
    return ok, out
