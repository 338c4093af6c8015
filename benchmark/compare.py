"""The comparison that decides ``correct``: the program's int16 PCM against
the plain reference's.

An error is the root mean square of the sample differences over the root
mean square of the reference's samples (at least 1); a length that differs
from the reference's reads infinity.  An error is taken over a whole lane
(an offline utterance, or a live stream's output from its first sample,
see ``drivers/stream.py``), giving ``err_median``, ``err_q75`` and
``err_max`` over the lanes checked, or over each hop of a live stream,
giving ``hop_median``, the median over every hop of every lane checked: a
number that one threshold flipped late in a single checked stream does not
move.  A cell's limits file,
``benchmark/limits/<cell>.json``, names those it compares, each with its
limit, beside the readings the limit was set from.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

LIMITS = Path(__file__).resolve().parent / "limits"


def error(got, want) -> float:
    got = np.asarray(got).reshape(-1)
    want = np.asarray(want).reshape(-1)
    if got.shape != want.shape or want.size == 0:
        return math.inf
    diff = got.astype(np.float64) - want.astype(np.float64)
    ref = np.sqrt(np.mean(want.astype(np.float64) ** 2))
    return float(np.sqrt(np.mean(diff * diff)) / max(ref, 1.0))


def lane_numbers(got: list, want: list) -> dict[str, float]:
    """``err_median``, ``err_q75`` and ``err_max`` over whole lanes."""
    errs = [error(g, w) for g, w in zip(got, want)]
    if len(got) != len(want) or not want:
        errs = [math.inf]
    return {"err_median": float(np.median(errs)),
            "err_q75": float(np.percentile(errs, 75)),
            "err_max": float(max(errs))}


def hop_numbers(got: list, want: list, shift: int) -> dict[str, float]:
    """``hop_median`` over the hops (``shift`` samples) of every lane."""
    errs = []
    for g, w in zip(got, want):
        g, w = np.asarray(g).reshape(-1), np.asarray(w).reshape(-1)
        if g.shape != w.shape or w.size % shift:
            errs.append(math.inf)
            continue
        errs += [error(a, b) for a, b in zip(g.reshape(-1, shift),
                                             w.reshape(-1, shift))]
    if len(got) != len(want) or not errs:
        errs = [math.inf]
    return {"hop_median": float(np.median(errs))}


def limits(cell: str) -> dict[str, float]:
    return json.loads((LIMITS / f"{cell}.json").read_text())["limits"]


def judge(nums: dict[str, float], lims: dict[str, float]):
    """(correct, {name: {"value": v, "limit": l}})."""
    checks = {k: {"value": nums[k], "limit": lims[k]} for k in lims}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
