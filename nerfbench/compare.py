"""The numbers that decide `correct`, each a gap between what the program
produced and what the reference produced from the same start.

A training cell compares three numbers, as the benchmark's contract sets
them out:
  loss_gap    the largest |program - reference| / |reference| of a step's
              loss over the compared steps;
  loss1_gap   the same of the first step's loss alone (steady from seed to
              seed where the later steps' losses carry Adam's amplified
              round-off, as a NeRF's do: PERF.md);
  grad_gap    by the worst leaf, |norm(program's first gradient) -
              norm(reference's)| over the larger of the reference leaf's
              norm and the median leaf's norm; the program's gradient is
              worked out from Adam's first moment after one step;
  change_gap  the same measure of each leaf's change from the start after
              the compared steps; leaves whose reference gradient is under
              a thousandth of the median leaf's are left out (they move by
              round-off alone).
"""

import math
import statistics

import torch


def loss_gap(prog, ref):
    if len(prog) != len(ref):
        return math.inf
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog, ref))


def _norm(t):
    return float(torch.linalg.vector_norm(t.double()))


def leaf_gaps(prog, ref, keep=None):
    """Each leaf's norm gap; prog and ref map leaf names to tensors."""
    names = [n for n in ref if keep is None or n in keep]
    if not names:
        return {"": math.inf}
    ref_n = {n: _norm(ref[n]) for n in names}
    med = statistics.median(ref_n.values())
    gaps = {}
    for n in names:
        p = prog.get(n)
        if p is None or tuple(p.shape) != tuple(ref[n].shape):
            gaps[n] = math.inf
        else:
            gaps[n] = abs(_norm(p) - ref_n[n]) / max(ref_n[n], med, 1e-30)
    return gaps


def leaf_gap(prog, ref, keep=None):
    """The worst leaf's norm gap."""
    return max(leaf_gaps(prog, ref, keep).values())


def moving_leaves(grad_ref):
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    norms = {n: _norm(g) for n, g in grad_ref.items()}
    med = statistics.median(norms.values())
    return {n for n, v in norms.items() if v >= 1e-3 * med}


def change(params, start):
    return {n: params[n].to(start[n].device) - start[n] for n in params}


def train_readings(prog, ref, start):
    """The three numbers of a training cell. prog and ref: dicts with
    losses, grad1, params (and optionally ema) by leaf; start: the
    parameters both began from."""
    keep = moving_leaves(ref["grad1"])
    d_prog = change(prog["params"], start)
    d_ref = change(ref["params"], start)
    for n in ref.get("ema", {}):
        d_prog["ema." + n] = prog["ema"][n].to(start[n].device) - start[n]
        d_ref["ema." + n] = ref["ema"][n].to(start[n].device) - start[n]
        if n in keep:
            keep = keep | {"ema." + n}
    return {
        "loss_gap": loss_gap(prog["losses"], ref["losses"]),
        "loss1_gap": loss_gap(prog["losses"][:1], ref["losses"][:1]),
        "grad_gap": leaf_gap(prog["grad1"], ref["grad1"]),
        "change_gap": leaf_gap(d_prog, d_ref, keep),
    }


def leaf_readings(prog, ref, start):
    """Per leaf, the gaps behind grad_gap and change_gap, with each
    leaf's reference norms (for a look at which leaf is worst)."""
    d_prog = change(prog["params"], start)
    d_ref = change(ref["params"], start)
    return {n: {"grad_gap": g, "change_gap": c,
                "grad_norm": _norm(ref["grad1"][n]),
                "change_norm": _norm(d_ref[n]),
                "numel": ref["params"][n].numel()}
            for (n, g), c in zip(
                leaf_gaps(prog["grad1"], ref["grad1"]).items(),
                leaf_gaps(d_prog, d_ref).values())}
