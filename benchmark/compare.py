"""The comparison that decides ``correct``: the numbers read from the
program's run against the reference's, each beside its limit.

Training (the first steps of the run, which set-up drives through the
window's own step on the window's own feed):

- ``loss_rel``: the largest relative gap of a step's loss;
- ``grad_gap``: by the worst slice (one layer's, or one expert's,
  matrix), the gap between the program's and the reference's norm of the
  first gradient, over the reference's norm of that slice or of the
  median slice, whichever is larger; ``grad_gap_median`` the median
  slice's gap (steady where bf16 routes a few tokens to other experts,
  which moves single expert slices);
- ``update_gap``: the same for each slice's change after the last
  compared step, leaving out slices whose reference gradient is under a
  thousandth of the median slice's (round-off alone moves them under
  Adam).

Serving: ``logit_gap``, the widest gap by which a served token's
reference logit lies below the reference's best at that position.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Sequence

import torch

#: Slices whose reference gradient norm is under this share of the median
#: slice's are left out of ``update_gap``.
FLAT_GRADIENT = 1e-3


def norm_gap(program: Dict[str, float], reference: Dict[str, float],
             keys: Sequence[str], pick=max) -> float:
    """``pick`` (the worst, or the median) over ``keys`` of the gap
    between the program's and the reference's norm of a slice, over the
    larger of the reference's norm of that slice and of the median
    slice."""
    med = statistics.median(reference[k] for k in reference)
    gaps = []
    for k in keys:
        gap = abs(program[k] - reference[k]) / max(reference[k], med, 1e-30)
        gaps.append(gap if math.isfinite(gap) else math.inf)
    return pick(gaps)


def train_numbers(program: dict, reference: dict) -> Dict[str, float]:
    """The numbers of two dicts of ``losses``, ``grad_norms`` and
    ``delta_norms`` (norms by slice key); a cell compares those its
    ``limits`` name."""
    n = len(reference["losses"])
    loss_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(program["losses"][:n], reference["losses"]))
    if not all(map(math.isfinite, program["losses"][:n])):
        loss_rel = math.inf
    g_ref = reference["grad_norms"]
    med = statistics.median(g_ref.values())
    moving = [k for k, v in g_ref.items() if v >= FLAT_GRADIENT * med]
    return {"loss_rel": loss_rel,
            "grad_gap": norm_gap(program["grad_norms"], g_ref, list(g_ref)),
            "grad_gap_median": norm_gap(program["grad_norms"], g_ref,
                                        list(g_ref), statistics.median),
            "update_gap": norm_gap(program["delta_norms"],
                                   reference["delta_norms"], moving)}


def served_gap(logits: List[torch.Tensor],
               served: List[Sequence[int]]) -> float:
    """The widest gap, over every served token, between the reference's
    best logit and the served token's, at the position that predicted
    it."""
    worst = 0.0
    for lg, toks in zip(logits, served):
        ids = torch.tensor(list(toks), device=lg.device)
        gap = lg.max(dim=-1).values - lg.gather(1, ids[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
    return worst


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> dict:
    """{name: {"value", "limit"}} for every number, and whether all are
    within their limits (a number that is not finite is not)."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return {"checks": checks, "correct": ok}
