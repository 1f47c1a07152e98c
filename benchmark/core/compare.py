"""The numbers that decide ``correct``, each held to a limit of its cell.

Training (the first three steps of the object the window drives, against
the reference from the same weights and batches):

  loss_gap         max over the steps of |loss - loss_ref| / |loss_ref|
  first_loss_gap   the same of the first step alone
  grad_norm_gap    max over the leaves of | |g| - |g_ref| | / max(|g_ref|,
                   the median leaf's |g_ref|): the first step's gradient as
                   the optimizer took it (after the clip), read back from
                   Adam's first moment (m_1 = (1 - beta1) g)
  update_norm_gap  the same of |theta_3 - theta_0|, leaving out the leaves
                   whose reference gradient is under a thousandth of the
                   median leaf's (Adam moves them by round-off alone)
  update_median_gap  the median over those leaves of the same

Serving (a sample of the window's answers, drawn from the seed, against the
reference on the same scans):

  probs_max_gap    max |p - p_ref| over every pixel and class
  probs_mean_gap   mean |p - p_ref|
  sigma_max_gap    max |s - s_ref| / max(|s_ref|, the median |s_ref| of its scan)
  sigma_mean_gap   the mean of the same
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass
from typing import Dict, List

import torch

GRAD_FLOOR = 1e-3  # leaves under this share of the median reference gradient


@dataclass
class TrainReadings:
    losses: List[float]
    grad_norms: Dict[str, float]  # "layer/leaf" -> |g| of step 1
    delta_norms: Dict[str, float]  # "layer/leaf" -> |theta_3 - theta_0|


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keys) -> Dict[str, float]:
    """Per leaf, | |prog| - |ref| | over the larger of |ref| and the median
    leaf's |ref|."""
    base = statistics.median(ref[k] for k in keys)
    return {k: abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], base) for k in keys}


def loss_gaps(prog: TrainReadings, ref: TrainReadings) -> List[float]:
    """Per step, |loss - loss_ref| / |loss_ref| (inf for a missing or
    non-finite loss)."""
    gaps = [abs(p - r) / abs(r) for p, r in zip(prog.losses, ref.losses)]
    gaps += [float("inf")] * (len(ref.losses) - len(gaps))
    return [g if g == g else float("inf") for g in gaps]


def moved(ref: TrainReadings) -> List[str]:
    """The leaves ``update_norm_gap`` holds: reference gradient at least
    :data:`GRAD_FLOOR` of the median leaf's."""
    floor = GRAD_FLOOR * statistics.median(ref.grad_norms.values())
    return sorted(k for k, v in ref.grad_norms.items() if v >= floor)


def train_numbers(prog: TrainReadings, ref: TrainReadings) -> Dict[str, float]:
    losses = loss_gaps(prog, ref)
    return {
        "loss_gap": max(losses),
        "first_loss_gap": losses[0],
        "grad_norm_gap": max(leaf_gaps(prog.grad_norms, ref.grad_norms,
                                       sorted(ref.grad_norms)).values()),
        "update_norm_gap": max(leaf_gaps(prog.delta_norms, ref.delta_norms,
                                         moved(ref)).values()),
        "update_median_gap": statistics.median(leaf_gaps(prog.delta_norms, ref.delta_norms,
                                                         moved(ref)).values()),
    }


def look(prog: TrainReadings, ref: TrainReadings) -> str:
    """Where the training numbers come from: each step's loss gap, the leaf
    with the widest gradient and change gaps, the leaves left out."""
    g = leaf_gaps(prog.grad_norms, ref.grad_norms, sorted(ref.grad_norms))
    d = leaf_gaps(prog.delta_norms, ref.delta_norms, moved(ref))
    gk, dk = max(g, key=g.get), max(d, key=d.get)
    out = sorted(set(ref.grad_norms) - set(moved(ref)))
    return (f"loss gaps by step {loss_gaps(prog, ref)}; widest gradient gap {gk} {g[gk]!r} "
            f"(|g| {prog.grad_norms.get(gk)!r} vs {ref.grad_norms[gk]!r}); widest change gap "
            f"{dk} {d[dk]!r}; left out of update_norm_gap: {out}")


class ServeGaps:
    """Accumulates the serving numbers over blocks of slices."""

    def __init__(self):
        self.p_max = self.s_max = 0.0
        self.p_sum = self.s_sum = 0.0
        self.count = 0

    def add(self, probs, sigma, probs_ref, sigma_ref, sigma_scale: float) -> None:
        dp = (probs - probs_ref).abs()
        ds = (sigma - sigma_ref).abs() / torch.clamp_min(sigma_ref.abs(), sigma_scale)
        bad = ~(torch.isfinite(probs).all() & torch.isfinite(sigma).all())
        self.p_max = max(self.p_max, float("inf") if bad else float(dp.max()))
        self.s_max = max(self.s_max, float("inf") if bad else float(ds.max()))
        self.p_sum += float(dp.double().sum())
        self.s_sum += float(ds.double().sum())
        self.count += dp.numel()

    def numbers(self) -> Dict[str, float]:
        n = max(self.count, 1)
        return {"probs_max_gap": self.p_max, "probs_mean_gap": self.p_sum / n,
                "sigma_max_gap": self.s_max, "sigma_mean_gap": self.s_sum / n}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every number that has a limit is within it (a number that
    is not a number fails)."""
    return all(numbers.get(k, float("inf")) <= v for k, v in limits.items())
