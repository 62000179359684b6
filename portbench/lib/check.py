"""The comparison that decides ``correct``: each loop's numbers (its
``compare``) against their limits in ``portbench/checks/<cell>.json``, and
the frame numbers that every viewer loop compares.

Frame numbers (uint8 frames as the viewer gets them, against the plain
reference's):

* ``px_off``: the share of compared pixels with a channel more than one
  level off (one level is the truncation of a value an ulp away);
* ``mean_gap``: the mean channel gap in levels over every compared pixel.
"""
from __future__ import annotations

import numpy as np


def compare_frames(frames, ref_frames) -> dict:
    if not frames or len(frames) != len(ref_frames) or any(
            a.shape != r.shape for a, r in zip(frames, ref_frames)):
        return dict(px_off=1.0, mean_gap=255.0)
    off, n, total = 0, 0, 0.0
    for a, r in zip(frames, ref_frames):
        d = np.abs(a.astype(np.int16) - r.astype(np.int16))
        off += int((d.max(axis=-1) > 1).sum())
        n += d.shape[0] * d.shape[1]
        total += float(d.sum(dtype=np.float64))
    return dict(px_off=off / n, mean_gap=total / (n * 3))


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {'value', 'limit'}}): every number at or under its
    limit; a number with no limit, or a limit with no number, fails."""
    out, ok = {}, True
    for name in sorted(set(numbers) | set(limits)):
        v = numbers.get(name)
        lim = limits.get(name)
        out[name] = {'value': v, 'limit': lim}
        if v is None or lim is None or not v <= lim:
            ok = False
    return ok, out
