"""The numbers that decide ``correct``, each the program's gap to the
plain reference, and their limits (``limits/<workload>.json``).

Serving (``out_rel_l2``): for every kept answer of the window and every
scan in it, ``||program - reference|| / ||reference||`` over that scan's
dense output (the BEV, so the row order of the input does not matter);
the worst scan counts.

Training, over the first ``compared_steps`` steps of the one trained
object (the reference follows them from the same weights on the same
batches):

* ``out_rel_l2``: the first step's output, as serving compares it, where
  the output is a dense map of the same shape on both sides (a net whose
  output is its active rows, in the program's row order, has none);
* ``loss``: the worst step's ``|loss - ref| / |ref|``, and
  ``loss_first``: the first step's;
* ``grad_norm``: by leaf, the first step's gradient as the update gets it
  (``p.grad``), ``| ||g|| - ||g_ref|| | / max(||g_ref||, the median
  leaf's ||g_ref||)``, the worst leaf;
* ``change_norm``: the same of each leaf's change ``p_n - p_0`` after the
  compared steps, against the median leaf's reference change;
* ``grad_norm_median`` and ``change_norm_median``: the median leaf's gap
  of the two, steadier from seed to seed than the worst leaf's.

Only the numbers that ``limits/<workload>.json`` names are compared.

Leaves whose reference gradient is under a thousandth of the median
leaf's (moved by round-off alone, if at all) are left out of both, by
that rule and not by name.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

EXCLUDE_BELOW = 1e-3  # of the median leaf's reference gradient norm


def serve_numbers(answers: Sequence[Tuple[torch.Tensor, torch.Tensor]]
                  ) -> Dict[str, float]:
    """``answers``: ``[(program output, reference output)]``, each
    ``[B, ...]``."""
    worst = 0.0
    for got, ref in answers:
        got, ref = got.float(), ref.float()
        for b in range(ref.shape[0]):
            den = float(ref[b].norm())
            num = float((got[b] - ref[b]).norm())
            worst = max(worst, num / den if den > 0 else math.inf)
    return {"out_rel_l2": worst}


def _median(values: List[float]) -> float:
    v = sorted(values)
    n = len(v)
    return v[n // 2] if n % 2 else 0.5 * (v[n // 2 - 1] + v[n // 2])


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` / ``ref``: ``{"out": tensor, "losses": [float],
    "grads": {name: tensor}, "change": {name: tensor}}``."""
    gaps = [abs(a - b) / abs(b) if b else math.inf
            for a, b in zip(prog["losses"], ref["losses"])]
    g_ref = {k: float(v.float().norm()) for k, v in ref["grads"].items()}
    g_med = _median(list(g_ref.values()))
    leaves = [k for k, v in g_ref.items() if v >= EXCLUDE_BELOW * g_med]
    g_med = _median([g_ref[k] for k in leaves])
    d_ref = {k: float(ref["change"][k].float().norm()) for k in leaves}
    d_med = _median(list(d_ref.values()))

    def by_leaf(norms_prog, norms_ref, med):
        out = []
        for k in leaves:
            den, gap = max(norms_ref[k], med), abs(norms_prog[k]
                                                   - norms_ref[k])
            out.append(gap / den if den > 0 else (0.0 if gap == 0
                                                  else math.inf))
        return out

    g = by_leaf({k: float(prog["grads"][k].float().norm()) for k in leaves},
                g_ref, g_med)
    d = by_leaf({k: float(prog["change"][k].float().norm())
                 for k in leaves}, d_ref, d_med)
    out = {"loss": max(gaps), "loss_first": gaps[0],
           "grad_norm": max(g), "grad_norm_median": _median(g),
           "change_norm": max(d), "change_norm_median": _median(d)}
    if prog.get("out") is not None and ref.get("out") is not None and \
            prog["out"].shape == ref["out"].shape:
        out.update(serve_numbers([(prog["out"], ref["out"])]))
    return out


def judge(numbers: Dict[str, float], limits: dict) -> Dict[str, dict]:
    """``{name: {"value", "limit", "ok"}}`` for every number the limits
    file compares; a number that is not finite fails."""
    out = {}
    for name, lim in limits["numbers"].items():
        v = numbers[name]
        out[name] = {"value": v, "limit": lim["limit"],
                     "ok": math.isfinite(v) and v <= lim["limit"]}
    return out
