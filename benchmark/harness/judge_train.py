"""Whether the training steps are correct: the program's first steps against
the reference's from the same parameters, batches and keys.

Numbers, each the worst case where not said otherwise:
  - `loss_gap`: |loss - reference loss| / |reference loss| over the steps;
  - `grad_gap`: over leaves, the gap between the norms of the program's and
    the reference's first clipped gradient (the program's read from Adam's
    first moment after one update), against the larger of the reference's
    norm of that leaf and of the median leaf;
  - `grad_rel_diff`: the norm of the difference of the two first gradients
    over all leaves, against the norm of the reference's;
  - `grad_rounding_ratio`: that norm of the difference against the same norm
    for the reference at the configuration's compute dtype (bfloat16): the
    program's departure in units of the rounding its precision implies. The
    first gradient of the signal loss is a sum of residuals that can nearly
    cancel at initialisation, which scales both norms alike from seed to seed;
  - `change_gap`: as `grad_gap`, for the change of each leaf over the steps.
    Leaves whose reference gradient is under a thousandth of the median
    leaf's (a key projection's bias under softmax) move by round-off alone
    and are left out of it;
  - `change_gap_median`: the median over those leaves of the same gap, the
    steady reading where one small leaf's change is mostly round-off.
A cell's limits file says which of them it compares (PERF.md says why).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

Run = Tuple[List[float], Dict[str, torch.Tensor], Dict[str, torch.Tensor]]


def _norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tree.items()}


def compare(program: Run, reference: Run, reference_cd: Run, start: Dict[str, torch.Tensor],
            detail: bool = False) -> Dict[str, float]:
    """`reference` at float32, `reference_cd` at the configuration's compute
    dtype (the rounding a sound program at that precision is expected to show)."""
    p_loss, p_g, p_after = program
    r_loss, r_g, r_after = reference
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(p_loss, r_loss))
    if len(p_loss) != len(r_loss):
        loss_gap = float("inf")
    rg, pg = _norms(r_g), _norms({k: p_g.get(k, torch.zeros(1)) for k in r_g})
    med_g = float(np.median(list(rg.values())))
    grad_gap = max(abs(pg[k] - rg[k]) / max(rg[k], med_g) for k in rg)
    diff2 = sum(float((p_g[k].double() - r_g[k].double()).square().sum()) if k in p_g
                else rg[k] ** 2 for k in rg)
    grad_rel_diff = float(np.sqrt(diff2 / max(sum(v * v for v in rg.values()), 1e-300)))
    c_g = reference_cd[1]
    rounding2 = sum(float((c_g[k].double() - r_g[k].double()).square().sum()) for k in rg)
    grad_rounding_ratio = float(np.sqrt(diff2 / max(rounding2, 1e-300)))
    moved = [k for k in rg if rg[k] >= 1e-3 * med_g]
    rd = {k: float((r_after[k].double() - start[k].double()).norm()) for k in moved}
    pd = {k: float((p_after[k].double() - start[k].double()).norm()) if k in p_after else 0.0
          for k in moved}
    med_d = float(np.median(list(rd.values())))
    gaps = [abs(pd[k] - rd[k]) / max(rd[k], med_d) for k in moved]
    out = {"loss_gap": float(loss_gap), "grad_gap": float(grad_gap),
           "grad_rel_diff": grad_rel_diff, "grad_rounding_ratio": grad_rounding_ratio,
           "change_gap": float(max(gaps)), "change_gap_median": float(np.median(gaps))}
    if detail:  # per leaf: reference and program gradient norms, difference, changes
        out["leaves"] = {k: [rg[k], pg[k], float((p_g[k].double() - r_g[k].double()).norm()),
                             rd.get(k), pd.get(k)] for k in rg}
        out["medians"] = [med_g, med_d]
    return out
