"""The entry of the reference notebook's own model: ``tpumcia_torch.run_pipeline``
with its random-forest head (100 trees, no depth cap), MDI and the
per-feature permutation sweep through the forest, judged against
``reference_forest.py`` by eight numbers:

- ``split_rows``, ``features_gap``: as ``correct.py`` reads them, against
  ``reference.py``'s float64 features and split;
- ``tree_nodes``: nodes of the 100 trees whose feature, threshold, children,
  ``n_node_samples`` or ``weighted_n_node_samples`` differ from the
  reference forest's, plus the difference in node counts (exact: integer
  bootstrap weights make every split sum exact in float64);
- ``proba_gap``: the widest gap of the forest's class shares on the test
  rows;
- ``mdi_gap``: the widest gap of MDI by column;
- ``column_rows``: the widest gap of a column's mean drop in the sweep, in
  test rows predicted otherwise (as ``correct.py``);
- ``rank_swaps``: channel pairs that the sums of their columns' drops rank
  the other way (as ``correct.py``, pairs more than twice the drops' room
  over a channel's columns apart);
- ``share_gap``: the widest gap, over every column and repeat of the sweep,
  of the drop in the test rows' mean share of their true class. Where no
  permutation turns a vote the accuracy drops all read 0 on both sides;
  the share drops still move with each permutation, so a sweep that skips
  a permutation or scores the wrong rows shows here.

The reference forest grows on the judged side's own float32 matrix and
split (a forest's splits jump with its features: a gap of 1e-6 of a
column's range can break a tie within ``FEATURE_THRESHOLD``, and the tree
below that node is another tree), so :func:`readings`, which alone sees
both sides, grows it; the feature stage is judged against ``reference.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench import correct, counts, reference, reference_forest, trace
from perfbench.entries import pipeline
from tpumcia_torch.importance.permutation import PermutationResult
from tpumcia_torch.utils.profiling import COUNTERS

if "share_importances" not in PermutationResult.__dataclass_fields__:
    # a program whose sweep keeps no share drops cannot be judged here: stop
    # before any set-up
    raise SystemExit("the forest entry judges the sweep's drops of the true class's share "
                     "(PermutationResult.share_importances), which this program does not keep")

REFERENCE = "reference_forest"  # perfbench/reference_forest.py: the plain reference
NUMBERS = ("split_rows", "features_gap", "tree_nodes", "proba_gap", "mdi_gap", "column_rows",
           "rank_swaps", "share_gap")
CONTROLS = reference_forest.CONTROLS
CLASSIC_BATCHED = 4096  # the classic path extracts larger collections batch by batch
_LAST_CALL = {}  # how far each of the program's counters rose over the last call


def call(inputs: dict, pipeline_settings: dict, device: torch.device, timer=None):
    """One ``run_pipeline`` call over the collection (not synchronised); the
    counters' rise over it is kept for :func:`shape`."""
    before = dict(COUNTERS)
    result = pipeline.call(inputs, pipeline_settings, device, timer)
    _LAST_CALL.clear()
    _LAST_CALL.update({k: v - before.get(k, 0) for k, v in COUNTERS.items()})
    return result


def _trees(trees) -> list[dict]:
    return [{k: np.asarray(getattr(t, k)) for k in reference_forest.TREE_FIELDS} for t in trees]


def program_outputs(result) -> dict:
    """What the judged call produced: the host matrix as float64 and as the
    float32 the head saw, the split, the forest's trees and its class shares
    on the test rows, MDI by column, the sweep's mean drops by column and
    their channel sums, and its drops of the true class's mean share by
    column and repeat."""
    values = np.asarray(result.features.values)
    te = result.test_idx
    with torch.no_grad():
        proba = result.head.predict_proba(np.nan_to_num(values[te].astype(np.float32)))
    return {
        "features": values.astype(np.float64),
        "matrix": np.nan_to_num(values.astype(np.float32)),
        "train_idx": np.asarray(result.train_idx), "test_idx": np.asarray(te),
        "trees": _trees(result.head.trees),
        "proba": proba.double().cpu().numpy(),
        "mdi": np.asarray(result.feature_result.feature_importances, dtype=np.float64),
        "column": np.asarray(result.channel_result.feature_importances, dtype=np.float64),
        "channel": np.asarray(result.channel_result.total, dtype=np.float64),
        "share": np.asarray(result.channel_result.extras["permutation"].share_importances,
                            dtype=np.float64),
    }


def _forest_settings(spec: dict, device) -> dict:
    p = spec["pipeline"]
    return {"head": {k: p["head"][k] for k in ("n_estimators", "max_depth", "seed")},
            "importance": {k: p["importance"][k] for k in ("n_repeats", "seed")},
            "device": device}


def _channel_sums(column, channels: int) -> np.ndarray:
    return np.array([column[cols].sum() for cols in reference.channel_columns(channels)])


def reference_outputs(spec: dict, inputs: dict, device, *, control=None) -> dict:
    """The reference's features and split (``reference.py``), and what
    :func:`readings` grows the reference forest from. A ``control`` (one of
    :data:`CONTROLS`) also grows its own forest, one precision step down,
    on the float32 of the reference's matrix: a judged side of its own."""
    st = pipeline.settings(spec["pipeline"])
    images = inputs["images"]
    if st["synth"]["noise_channels"] > 0:
        levels = reference.noise_stack(images, num_noise=st["synth"]["noise_channels"],
                                       var=st["synth"]["var"], seed=st["synth"]["seed"],
                                       batch=st["batch_size"])
    else:
        levels = images.permute(0, 3, 1, 2)
    X = reference.features(levels, inputs["mask"], levels_n=st["levels"], offset=st["offset"])
    labels = np.asarray(inputs["labels"])
    sp = st["split"]
    tr, te = reference.split(len(X), test_size=sp["test_size"], seed=sp["seed"],
                             stratify=labels if sp.get("stratify") else None,
                             groups=inputs["groups"] if sp.get("group_by") else None)
    out = {"features": X.cpu().numpy(), "train_idx": tr, "test_idx": te, "labels": labels,
           "channels": levels.shape[1], "forest": _forest_settings(spec, device),
           "repeats": st["importance"]["n_repeats"]}
    if control is not None:
        matrix = np.nan_to_num(out["features"].astype(np.float32))
        forest = reference_forest.analyze(matrix, labels, tr, te, **out["forest"], control=control)
        out.update(matrix=matrix, trees=forest["trees"], proba=forest["proba"], mdi=forest["mdi"],
                   column=forest["column"], channel=_channel_sums(forest["column"], out["channels"]),
                   share=forest["share"])
    return out


def differing_nodes(got: list[dict], want: list[dict]) -> int:
    """Nodes that differ in any of ``TREE_FIELDS``, plus the difference in
    node counts, over the trees (a tree missing on one side counts all its
    nodes)."""
    n = sum(len(t["feature"]) for t in (got[len(want):] + want[len(got):]))
    for a, b in zip(got, want):
        m = min(len(a["feature"]), len(b["feature"]))
        differ = np.zeros(m, bool)
        for k in reference_forest.TREE_FIELDS:
            differ |= np.asarray(a[k])[:m] != np.asarray(b[k])[:m]
        n += int(differ.sum()) + abs(len(a["feature"]) - len(b["feature"]))
    return n


def readings(prog: dict, ref: dict, limits: dict) -> dict:
    """Each number's reading: the reference forest grown on ``prog``'s own
    matrix and split (``prog``: the program's outputs or a control's)."""
    forest = reference_forest.analyze(prog["matrix"], ref["labels"], prog["train_idx"],
                                      prog["test_idx"], **ref["forest"])
    judged = {**ref, "proba": forest["proba"], "column": forest["column"],
              "channel": _channel_sums(forest["column"], ref["channels"])}
    per_channel = len(reference.channel_columns(ref["channels"])[0])
    # channel sums hold each column's room in drops: pairs closer than that may swap
    shared = correct.readings(prog, judged,
                              {"channel_rows": per_channel * limits.get("column_rows", 0)})
    mdi_p, mdi_r = np.asarray(prog["mdi"]), forest["mdi"]
    same = shared["split_rows"] == 0 and mdi_p.shape == mdi_r.shape
    share_p, share_r = np.asarray(prog["share"]), forest["share"]
    return {
        "split_rows": shared["split_rows"], "features_gap": shared["features_gap"],
        "tree_nodes": differing_nodes(prog["trees"], forest["trees"]),
        "proba_gap": shared["proba_gap"],
        "mdi_gap": float(np.abs(mdi_p - mdi_r).max()) if same else float("inf"),
        "column_rows": shared["column_rows"], "rank_swaps": shared["rank_swaps"],
        "share_gap": (float(np.abs(share_p - share_r).max()) if share_p.shape == share_r.shape
                      else float("inf")),
    }


def shape(spec: dict, result, labels) -> dict:
    """The cell's shapes, and the program's counters over the last call (the
    split call's, in a traced run)."""
    return {"objects": spec["data"]["objects"], "n_train": len(result.train_idx),
            "n_test": len(result.test_idx), "trees": len(result.head.trees),
            "counters": dict(_LAST_CALL)}


def expected_kernels(spec: dict, calls: int) -> dict:
    """The classic path's GLCM statistics launches, each call: one a batch
    of a collection larger than ``CLASSIC_BATCHED``, else one."""
    n, batch = spec["data"]["objects"], spec["pipeline"]["batch_size"]
    launches = counts.glcm_launches(n, batch) if n > CLASSIC_BATCHED else 1
    return {trace.GLCM_KERNEL: calls * launches}
