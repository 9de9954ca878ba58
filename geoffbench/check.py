"""The comparison that decides ``correct``: the served labels and logits of
a seeded sample of the finished requests against the plain reference run
on the same inputs, plus exact checks of every answer."""
from __future__ import annotations

import random

import torch

from geoffbench.traffic import derive


def sample(requests: list, k: int, seed: int) -> list:
    """k finished requests drawn from the seed, the longest among them."""
    if not requests:
        return []
    longest = max(requests, key=lambda r: (r.tokens, -r.index))
    rest = [r for r in requests if r is not longest]
    rng = random.Random(derive(seed, "sample"))
    return [longest] + rng.sample(rest, min(k - 1, len(rest)))


def compared(labels: list, logits: list, ref: list) -> dict:
    """The numbers of a sample. ``labels``/``logits``: what was served (or
    what the control puts first, and its logits); ``ref``: the reference's
    float32 logits.

    logits_rel_err    worst ||served - ref|| / ||ref|| over the sample
    label_gap         worst (ref's best - ref at the served label), in
                      standard deviations of the ref's logits
    label_not_argmax  served labels that are not a largest served logit
    """
    rel, gap, bad = 0.0, 0.0, 0
    for lab, got, want in zip(labels, logits, ref):
        got, want = got.float().cpu(), want.float().cpu()
        rel = max(rel, float(torch.linalg.vector_norm(got - want)
                             / torch.linalg.vector_norm(want)))
        gap = max(gap, float((want.max() - want[lab]) / want.std()))
        bad += int(bool(got[lab] < got.max()))
    return {"logits_rel_err": rel, "label_gap": gap, "label_not_argmax": bad}


REQUIRED = ("failed", "misrouted", "logits_rel_err", "label_not_argmax")


def verdict(numbers: dict, limits: dict) -> tuple:
    """(every number within its limit, {name: {"value", "limit"}}), over
    the numbers the cell's limits file names; a number of ``REQUIRED``
    missing from it, or not measured, fails. A number without a limit is
    shown with limit None and decides nothing."""
    checks, ok = {}, True
    for name in REQUIRED:
        if limits.get(name, {}).get("limit") is None or name not in numbers:
            ok = False
    for name, value in numbers.items():
        lim = limits.get(name, {}).get("limit")
        checks[name] = {"value": value, "limit": lim}
        if lim is not None:
            ok = ok and value <= lim
    return ok, checks
