"""The comparison that decides ``correct``: what the timed calls produced
against the plain reference, number by number, each against the limit its
cell's traffic file gives (``limits``). :func:`judge` takes the numbers an
entry names (``entries/<entry>.py``'s ``NUMBERS``); :func:`readings` reads
the six of the ``pipeline`` entry against ``reference.py``:

- ``split_rows``: rows on the other side of the train/test split (exact);
- ``features_gap``: the widest gap of the feature matrix, each column's gap
  over that column's range in the reference (the head sees the columns
  MinMax-scaled, so a gap counts by the share of the range it moves);
- ``proba_gap``: the widest gap of the head's class probabilities on the
  test rows;
- ``channel_rows``: the widest gap of a channel's mean accuracy drop under
  the channel sweep, counted in test rows predicted otherwise (the gap
  times the test rows times the repeats, rounded: a count, so the float32
  rounding of an accuracy counts nothing);
- ``column_rows``: the same of a column under the per-column sweep;
- ``rank_swaps``: pairs of channels that the program ranks in the other
  order, among the pairs whose drops in the reference lie more than twice
  ``channel_rows``' limit and half a row apart (exact; drops closer than
  half a row are one count, apart only by rounding).
"""

from __future__ import annotations

import numpy as np

NUMBERS = ("split_rows", "features_gap", "proba_gap", "channel_rows", "column_rows", "rank_swaps")


def _features_gap(prog: np.ndarray, ref: np.ndarray) -> float:
    if prog.shape != ref.shape:
        return float("inf")
    nan_p, nan_r = np.isnan(prog), np.isnan(ref)
    if (nan_p != nan_r).any():
        return float("inf")
    span = np.nanmax(ref, axis=0) - np.nanmin(ref, axis=0)
    span = np.where(span > 0, span, np.maximum(np.nanmax(np.abs(ref), axis=0), 1.0))
    gap = np.abs(np.where(nan_r, 0.0, prog - ref)) / span
    return float(gap.max())


def _widest(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return float("inf")
    return float(np.abs(a - b).max()) if a.size else 0.0


def _count(x: float):
    return round(x) if np.isfinite(x) else float("inf")


def readings(prog: dict, ref: dict, limits: dict) -> dict:
    """Each number's reading. ``prog`` and ``ref`` hold ``features``,
    ``train_idx``, ``test_idx``, ``proba``, ``channel`` and ``column``;
    ``ref`` also ``repeats``."""
    n = len(ref["features"])
    side_p, side_r = np.zeros(n, bool), np.zeros(n, bool)
    side_p[np.asarray(prog["test_idx"])] = True
    side_r[np.asarray(ref["test_idx"])] = True
    split_rows = int((side_p != side_r).sum()) + abs(len(prog["features"]) - n)
    same_split = split_rows == 0
    rows = len(ref["test_idx"]) * ref["repeats"]  # a drop's unit is 1 / rows
    # without a limit for channel_rows (then not correct) pairs count half a row apart
    apart = (2 * limits.get("channel_rows", 0) + 0.5) / rows
    ch_p, ch_r = np.asarray(prog["channel"]), np.asarray(ref["channel"])
    swaps = 0
    if ch_p.shape == ch_r.shape:
        for a in range(len(ch_r)):
            for b in range(len(ch_r)):
                if ch_r[a] - ch_r[b] > apart and not ch_p[a] > ch_p[b]:
                    swaps += 1
    else:
        swaps = len(ch_r)
    inf = float("inf")
    return {
        "split_rows": split_rows,
        "features_gap": _features_gap(np.asarray(prog["features"]), np.asarray(ref["features"])),
        "proba_gap": _widest(prog["proba"], ref["proba"]) if same_split else inf,
        "channel_rows": _count(_widest(ch_p, ch_r) * rows) if same_split else inf,
        "column_rows": _count(_widest(prog["column"], ref["column"]) * rows) if same_split else inf,
        "rank_swaps": swaps,
    }


def judge(numbers: dict, limits: dict, names) -> tuple[bool, dict]:
    """(each of ``names`` read and within its limit, {name: {"value",
    "limit"}}); a reading that is missing or not finite (shapes that differ)
    is written as null, and so is a limit the traffic file does not give:
    either is not correct."""
    def value(k):
        v = numbers.get(k)
        return v if v is not None and np.isfinite(v) else None

    checks = {k: {"value": value(k), "limit": limits.get(k)} for k in names}
    ok = bool(names) and all(c["value"] is not None and c["limit"] is not None
                             and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
