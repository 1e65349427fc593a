"""The port's random forest against the benchmark's plain reference
(``perfbench/reference_forest.py``), on the CPU at a small size: the
chunked, level-by-level grower (``models/forest_fit.py``) against the
node-by-node one, inference (``apply`` and ``apply_permuted``), MDI and
the per-feature sweep;
the reference against sklearn's own tree; and planted faults read as such.
This file imports no jax.

Tolerances:
- trees: node for node equal, thresholds bit-equal (integer bootstrap
  weights make every split sum exact in float64, in any order);
- class shares: 1e-6 (the port's float32 leaf fractions, averaged in
  float32, against float64);
- MDI: 1e-12 (float64 on both sides, sums in another order);
- sweep drops: the same predictions, so the drops differ by the float32
  rounding of the port's accuracies only (1.2e-7, one float32 ulp at 1);
- the sweep's drops of the true class's mean share: 1e-6 (float32 shares
  averaged over the rows in float32, against float64).
"""

import functools

import numpy as np
import pytest
import torch
from sklearn.tree import DecisionTreeClassifier

from perfbench import reference_forest
from perfbench.entries import forest as forest_entry
from tpumcia_torch.importance import permutation as perm
from tpumcia_torch.models import forest_fit
from tpumcia_torch.models.forest_device import DeviceForest
from tpumcia_torch.models.heads import RandomForestHead, forest_mdi

ROWS, COLUMNS, CLASSES, TREES = 240, 69, 6, 8


def _matrix(seed, n=ROWS):
    """(n, 69) float32 rows of 6 classes: a class signal in the first six
    columns, rounded columns (ties), 40 constant columns (nodes that visit
    past ``max_features``) and a column of steps closer than
    ``FEATURE_THRESHOLD``."""
    rng = np.random.default_rng(seed)
    y = rng.permutation(np.arange(n) % CLASSES)
    X = rng.normal(size=(n, COLUMNS)).astype(np.float32)
    X[:, :CLASSES] += 0.9 * (y[:, None] == np.arange(CLASSES))
    X[:, 10:20] = np.round(X[:, 10:20])
    X[:, 20:60] = 0.5
    X[:, 60] = (1.0 + 5e-8 * rng.integers(0, 4, n)).astype(np.float32)
    return X, y


def _as_dicts(trees):
    return [{k: getattr(t, k) for k in reference_forest.TREE_FIELDS} for t in trees]


def _fit_both(seed):
    X, y = _matrix(seed)
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    got = forest_fit.fit_forest(Xt, yt, CLASSES, n_estimators=TREES, max_depth=None, seed=seed)
    want = reference_forest.grow_forest(Xt, yt, CLASSES, n_estimators=TREES, max_depth=None,
                                        seed=seed)
    return got, want


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("per_chunk", [TREES, 3])
def test_port_forest_equals_the_reference_node_for_node(seed, per_chunk, monkeypatch):
    """``fit_forest``, all trees in one chunk or three a chunk, against the
    reference grown one node at a time from the same seeded streams."""
    monkeypatch.setattr(forest_fit, "grow_trees", functools.partial(
        forest_fit.grow_trees, chunk_elems=per_chunk * ROWS * COLUMNS))
    got, want = _fit_both(seed)
    assert len(got) == len(want) == TREES
    assert forest_entry.differing_nodes(_as_dicts(got), want) == 0
    for g, w in zip(got, want):
        assert g.node_count == len(w["feature"]) > 10 and g.max_depth == w["max_depth"]
        for k in reference_forest.TREE_FIELDS:
            np.testing.assert_array_equal(getattr(g, k), w[k], err_msg=k)
        np.testing.assert_array_equal(g.value, w["value"])
        np.testing.assert_array_equal(g.impurity, w["impurity"])


@pytest.mark.parametrize("call", ["apply", "apply_permuted"])
def test_device_forest_shares_equal_the_references(call):
    """The forest's class shares on rows it was not grown on, by ``apply``
    and by ``apply_permuted`` under identity permutations (two groups of
    all columns, two repeats: each draw the rows as they are)."""
    got, want = _fit_both(2)
    forest = DeviceForest.from_arrays(got, np.arange(CLASSES), device="cpu")
    X = torch.from_numpy(_matrix(102)[0])
    if call == "apply":
        shares = forest.apply(X)[None]
    else:
        shares = forest.apply_permuted(X, torch.arange(ROWS).repeat(4, 1), torch.ones((2, COLUMNS)), 2)
    ref = reference_forest.class_shares([reference_forest.on_device(t, "cpu") for t in want], X)
    assert shares.shape == (1 if call == "apply" else 4, ROWS, CLASSES)
    for s in shares:
        np.testing.assert_allclose(s.double().numpy(), ref.numpy(), rtol=0, atol=1e-6)


def test_mdi_equals_the_references():
    got, want = _fit_both(3)
    mdi = forest_mdi(got, COLUMNS)
    assert mdi[:CLASSES].sum() > 0.3  # the signal columns lead
    np.testing.assert_allclose(mdi, reference_forest.mdi(want, COLUMNS), rtol=0, atol=1e-12)


def test_forest_sweep_equals_the_references():
    """``permutation_importance`` through the forest against the reference's
    drops on the same permutations (drawn alike from the seed)."""
    got, want = _fit_both(4)
    head = RandomForestHead(got, np.arange(CLASSES), num_features=COLUMNS, device="cpu")
    X, y = _matrix(104, n=120)
    res = perm.permutation_importance(head, X, y, n_repeats=3, seed=5)
    drops, _ = reference_forest.column_drops(
        [reference_forest.on_device(t, "cpu") for t in want], torch.from_numpy(X),
        torch.from_numpy(y), n_repeats=3, seed=5, share_dtype=torch.float64)
    assert np.abs(drops.numpy()).max() > 0
    np.testing.assert_allclose(res.importances_mean, drops.numpy(), rtol=0, atol=1.2e-7)


@pytest.mark.parametrize("n_repeats", [1, 3])
def test_forest_sweep_share_drops_equal_the_references(n_repeats):
    """The sweep's drops of the rows' mean share of their true class, each
    column and repeat, against the reference's; a label never seen in
    training counts a share of 0 on both sides."""
    got, want = _fit_both(4)
    head = RandomForestHead(got, np.arange(CLASSES), num_features=COLUMNS, device="cpu")
    X, y = _matrix(105, n=120)
    y[:3] = CLASSES  # unseen in training
    res = perm.permutation_importance(head, X, y, n_repeats=n_repeats, seed=6)
    _, shares = reference_forest.column_drops(
        [reference_forest.on_device(t, "cpu") for t in want], torch.from_numpy(X),
        torch.from_numpy(np.where(y < CLASSES, y, -1)), n_repeats=n_repeats, seed=6,
        share_dtype=torch.float64)
    assert res.share_importances.shape == (COLUMNS, n_repeats)
    assert np.count_nonzero(shares.numpy()) > COLUMNS // 4  # moves where votes hold
    np.testing.assert_allclose(res.share_importances, shares.numpy(), rtol=0, atol=1e-6)
    assert 0 < res.baseline_share < 1


def test_a_logistic_sweep_keeps_no_share_drops():
    """Only a forest's sweep (class probabilities) keeps share drops."""
    from tpumcia_torch.config import HeadConfig
    from tpumcia_torch.models.heads import fit_head

    X, y = _matrix(106, n=120)
    head = fit_head(X, y, device="cpu", config=HeadConfig(num_steps=5))
    res = perm.permutation_importance(head, X, y, n_repeats=2, seed=7)
    assert res.share_importances is None and res.baseline_share is None


def _gaussian(seed, n=300, f=10, k=3):
    """Tie-free continuous rows (3 classes) with the label in feature 0, and
    bootstrap counts as sample weights (zeros included)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, k, n)
    X = rng.normal(size=(n, f)).astype(np.float32)
    X[:, 0] += 0.8 * y
    w = np.bincount(rng.integers(0, n, n), minlength=n).astype(np.float64)
    return X, y, w


def _sklearn_orders(tree_, num_features):
    """A feature order per node that visits sklearn's chosen feature first
    (as ``test_torch_forest.py`` builds it): with every feature visited, the
    grower reproduces sklearn's tree where sklearn's choice is a first
    maximum of the Gini proxy. Nodes keyed by depth, left to right."""
    by_depth, frontier = [], [0]
    while frontier:
        by_depth.append([int(tree_.feature[n]) for n in frontier])
        frontier = [c for n in frontier if tree_.children_left[n] != -1
                    for c in (tree_.children_left[n], tree_.children_right[n])]

    def orders(depth, n):
        out = np.tile(np.arange(num_features), (n, 1))
        for i, f in enumerate(by_depth[depth][:n] if depth < len(by_depth) else []):
            if f >= 0:
                out[i] = [f] + [g for g in range(num_features) if g != f]
        return torch.from_numpy(out)

    return orders


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("max_depth", [None, 4])
def test_reference_tree_equals_sklearns(seed, max_depth):
    """The reference's grower against ``DecisionTreeClassifier``
    (``max_features=None``) with the same bootstrap counts as
    ``sample_weight``."""
    X, y, w = _gaussian(seed)
    sk = DecisionTreeClassifier(max_depth=max_depth, random_state=seed).fit(X, y, sample_weight=w)
    got = reference_forest.grow_tree(torch.from_numpy(X), torch.from_numpy(y), 3,
                                     torch.from_numpy(w), _sklearn_orders(sk.tree_, X.shape[1]),
                                     max_features=X.shape[1], max_depth=max_depth)
    t = sk.tree_
    assert len(got["feature"]) == t.node_count > 20 and got["max_depth"] == t.max_depth
    for k in reference_forest.TREE_FIELDS:
        np.testing.assert_array_equal(got[k], np.asarray(getattr(t, k)), err_msg=k)
    for k in ("value", "impurity"):
        np.testing.assert_allclose(got[k], np.asarray(getattr(t, k)), rtol=0, atol=1e-12,
                                   err_msg=k)


def _nudged(assemble):
    def assembled(*a, **kw):
        """One threshold of the first tree moved up by one float64 ulp."""
        trees = assemble(*a, **kw)
        t = trees[0]
        i = int(np.flatnonzero(t.feature >= 0)[-1])
        t.threshold[i] = np.nextafter(t.threshold[i], np.inf)
        return trees
    return assembled


def _recounted(grow):
    def grown(X, y, K, weights, **kw):
        """One more draw of the first tree's first row in its bootstrap."""
        weights = weights.clone()
        weights[0, int(torch.nonzero(weights[0])[0])] += 1
        return grow(X, y, K, weights, **kw)
    return grown


@pytest.mark.parametrize("fault", ["threshold_nudged", "bootstrap_count"])
def test_a_planted_fault_is_read(fault, monkeypatch):
    if fault == "threshold_nudged":
        monkeypatch.setattr(forest_fit, "_assemble", _nudged(forest_fit._assemble))
    else:
        monkeypatch.setattr(forest_fit, "grow_trees", _recounted(forest_fit.grow_trees))
    got, want = _fit_both(5)
    assert forest_entry.differing_nodes(_as_dicts(got), want) > 0
