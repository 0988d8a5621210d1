"""The numbers that decide ``correct``: the program's warm-up against the
plain reference, on the same inputs, weights and random stream.

* ``loss``: the worst of the first steps' relative loss gaps;
* ``grad``: the worst leaf's gap between the first gradient's norms, the
  program's as its optimizer got it, over the larger of the reference
  leaf's norm and the median leaf's;
* ``change``: the same for each leaf's change over the first steps, over the
  leaves whose reference gradient is at least a thousandth of the median
  leaf's (the others move by round-off alone);
* ``eval``: the widest gap, over the nodes, by which the reference's logit of
  the class the program's evaluation predicted lies below the reference's
  best logit of that node.

Each is compared with its own limit (``cells/<cell>.json``)."""

from __future__ import annotations

import statistics
from typing import Dict, Optional

import numpy as np
import torch

NUMBERS = ("loss", "grad", "change", "eval")
# a leaf moves by round-off alone where its reference gradient norm is below
# this share of the median leaf's
STILL_LEAF = 1e-3


def _max(xs) -> float:
    """The largest value; NaN when any value is NaN (Python's max skips it)."""
    xs = [float(x) for x in xs]
    return float("nan") if any(x != x for x in xs) else max(xs)


def _worst_leaf(prog: Dict[str, float], ref: Dict[str, float], keys) -> float:
    keys = list(keys)
    med = statistics.median(ref[k] for k in keys)
    return _max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys)


def readings(prog: Dict, ref: Dict, n: int) -> Dict[str, float]:
    """The four numbers of one run (see the module's docstring)."""
    loss = _max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    g_ref = ref["grad_norms"]
    med_g = statistics.median(g_ref.values())
    moving = [k for k in g_ref if g_ref[k] >= STILL_LEAF * med_g]
    logits = ref["eval_logits"].double()[:n]
    pred = torch.from_numpy(np.asarray(prog["eval_pred"])[:n].astype(np.int64))
    bad = (pred < 0) | (pred >= logits.shape[1])
    gap = logits.max(1).values - logits.gather(1, pred.clamp(0, logits.shape[1] - 1)[:, None])[:, 0]
    gap = torch.where(bad, float("inf"), gap)
    return {"loss": float(loss),
            "grad": float(_worst_leaf(prog["grad_norms"], g_ref, g_ref)),
            "change": float(_worst_leaf(prog["change_norms"], ref["change_norms"], moving)),
            "eval": float(gap.max()) if torch.isfinite(logits).all() else float("nan")}


def judge(values: Dict[str, float], limits: Dict[str, float]) -> Optional[bool]:
    """True when every number is within its limit; False when one is not
    or a limit is missing."""
    ok = True
    for k in NUMBERS:
        v, lim = values.get(k), limits.get(k)
        if lim is None or v is None or not (v <= lim):
            ok = False
    return ok


def checks(values: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict]:
    return {k: {"value": values.get(k), "limit": limits.get(k)} for k in NUMBERS}


def diagnostics(prog: Dict, ref: Dict, n: int) -> Dict:
    """What the limits are set from, beyond the numbers: each step's loss
    gap, the worst leaves, and the evaluation's gaps (absolute, relative to
    the node's logit range, counts over relative thresholds, argmax
    disagreements, the logits' largest magnitude)."""
    g_ref, c_ref = ref["grad_norms"], ref["change_norms"]
    med_g = statistics.median(g_ref.values())
    moving = [k for k in g_ref if g_ref[k] >= STILL_LEAF * med_g]
    med_c = statistics.median(c_ref[k] for k in moving)

    def worst(p, r, keys, med):
        return sorted(((abs(p[k] - r[k]) / max(r[k], med, 1e-30), k) for k in keys),
                      reverse=True)[:3]
    logits = ref["eval_logits"].double()[:n]
    pred = torch.from_numpy(np.asarray(prog["eval_pred"])[:n].astype(np.int64)).clamp(
        0, logits.shape[1] - 1)
    top = logits.max(1).values
    gap = top - logits.gather(1, pred[:, None])[:, 0]
    rel = gap / (top - logits.min(1).values).clamp_min(1e-30)
    return {"loss_steps": [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])],
            "grad_worst": worst(prog["grad_norms"], g_ref, g_ref, med_g),
            "change_worst": worst(prog["change_norms"], c_ref, moving, med_c),
            "still_leaves": sorted(set(g_ref) - set(moving)),
            "eval_abs": float(gap.max()), "eval_rel": float(rel.max()),
            "eval_rel_over": {str(t): int((rel > t).sum()) for t in (1e-4, 1e-3, 1e-2, 1e-1)},
            "eval_disagree": int((gap > 0).sum()), "logit_absmax": float(logits.abs().max())}
