"""The numbers that decide ``correct``, worked out from the program's
readings and the reference's."""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Tuple

from portbench.lib.stats import median

# a leaf whose reference gradient is under this share of the median
# leaf's moves under Adam by round-off alone: its change is not compared
STILL_LEAF = 1e-3


def moving_leaves(first_grad: Dict[str, float]) -> set:
    med = median(list(first_grad.values()))
    return {p for p, v in first_grad.items() if v >= STILL_LEAF * med}


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                   leaves: Optional[Iterable[str]] = None
                   ) -> Tuple[float, str]:
    """The largest gap between the program's norm of a leaf and the
    reference's, against the reference's norm of that leaf or of the
    median leaf, whichever is larger: (gap, leaf)."""
    med = median(list(ref.values()))
    worst, where = 0.0, ""
    for leaf in (ref if leaves is None else leaves):
        if leaf not in prog:
            return float("inf"), leaf
        base = max(ref[leaf], med)
        gap = abs(prog[leaf] - ref[leaf]) / base if base > 0 else (
            0.0 if prog[leaf] == 0 else float("inf"))
        if gap > worst:
            worst, where = gap, leaf
    return worst, where


def loss_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    """The largest gap between a step's loss and the reference's."""
    if len(prog) < len(ref):
        return float("inf")
    return max(abs(a - b) for a, b in zip(prog, ref))


def sketch_gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """Each leaf's ``|S(prog) - S(ref)| / |S(ref)|`` over its sketch."""
    out = {}
    for p, r in ref.items():
        base = float(r.norm())
        if base > 0:
            out[p] = float((prog[p] - r).norm()) / base if p in prog \
                else float("inf")
    return out


def median_gap(gaps: Dict[str, float]) -> Tuple[float, str]:
    ranked = sorted((v, p) for p, v in gaps.items())
    return ranked[(len(ranked) - 1) // 2]


def train_numbers(prog: dict, ref: dict) -> Dict[str, Tuple[float, str]]:
    """name -> (value, where) of the numbers a training cell compares:
    loss_gap (the first step's loss: a later step's swings with the
    first update, see PERF.md), grad_gap (the first gradient's norm, by
    the worst leaf), grad_sketch_gap (the first gradient's sketch, by
    the median leaf: the number the fp8 control fails, see PERF.md) and
    change_gap (the parameters' change over the followed steps, by the
    worst moving leaf)."""
    grad, grad_leaf = worst_leaf_gap(prog["first_grad"], ref["first_grad"])
    change, change_leaf = worst_leaf_gap(
        prog["change"], ref["change"], moving_leaves(ref["first_grad"]))
    return {
        "loss_gap": (loss_gap(prog["losses"][:1], ref["losses"][:1]),
                     "step 1"),
        "grad_gap": (grad, grad_leaf),
        "grad_sketch_gap": median_gap(sketch_gaps(prog["first_sketch"],
                                                  ref["first_sketch"])),
        "change_gap": (change, change_leaf),
    }


def train_detail(prog: dict, ref: dict) -> dict:
    """Every leaf's gaps and every step's, for setting the limits."""
    med_g = median(list(ref["first_grad"].values()))
    med_c = median(list(ref["change"].values()))
    return {
        "loss_by_step": [abs(a - b) for a, b in
                         zip(prog["losses"], ref["losses"])],
        "grad_by_leaf": {
            p: abs(prog["first_grad"][p] - v) / max(v, med_g)
            for p, v in ref["first_grad"].items()},
        "change_by_leaf": {
            p: abs(prog["change"][p] - v) / max(v, med_c)
            for p, v in ref["change"].items()},
        "sketch_by_leaf": sketch_gaps(prog["first_sketch"],
                                      ref["first_sketch"]),
        "still_leaves": sorted(set(ref["first_grad"])
                               - moving_leaves(ref["first_grad"])),
    }


def judged(numbers: Dict[str, Tuple[float, str]], limits: dict
           ) -> Tuple[Dict[str, Tuple[float, Optional[float]]], bool]:
    """Each number beside its limit, and whether every compared number
    is within its limit.  A number whose limit is null is reported and
    not compared; one with no limit entry at all fails."""
    checks, ok = {}, True
    for name, (value, _where) in numbers.items():
        if name not in limits:
            checks[name] = (value, None)
            ok = False
            continue
        limit = limits[name]
        checks[name] = (value, limit)
        if limit is not None and not value <= limit:
            ok = False
    return checks, ok
