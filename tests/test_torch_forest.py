"""The random-forest head of tpumcia_torch against sklearn and tpumcia, on
the CPU: the port's own tree grower (``models/forest_fit.py``) against
sklearn's trees, a fitted sklearn forest carried across
(``RandomForestHead.from_sklearn``), its walk against tpumcia's GEMM and
lock-step forms, MDI, the forest sweeps (device and host), the port's own
forest against tpumcia's, and the classic ``run_pipeline`` slice with the
forest head.

Tolerances:
- tree structure, ``n_node_samples``: equal; thresholds: bit-equal;
  ``value``, ``impurity``, ``weighted_n_node_samples``: 1e-12 (every sum is
  an integer in float64, so these are exact in practice);
- forest probabilities against sklearn: 1e-6 (f32 leaf fractions, averaged
  in f32);
- MDI against ``feature_importances_``: 1e-12 (float64, the same order);
- sweep drops: the same predictions (fully grown trees have 0/1 leaves and
  8 trees average them exactly), so the drops differ by f32 rounding of the
  accuracies only (1.2e-7, one f32 ulp at 1);
- the port's own forest against tpumcia's (other random streams): accuracy
  within 0.05, channel rankings equal.
"""

import functools
import inspect
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.tree import DecisionTreeClassifier

from torch_parity import (WALK_CASES, WALK_FEATURES, WALK_REPEATS, WALK_ROWS, random_tree, replay_jax_draws,
                          walk_case)
from tpumcia.config import HeadConfig as JHeadConfig
from tpumcia.config import ImportanceConfig as JImportanceConfig
from tpumcia.importance import channels as jchannels
from tpumcia.importance import permutation as jperm
from tpumcia.models import forest_device as jforest_device
from tpumcia.models import heads as jheads
from tpumcia.models.forest_device import DeviceForest as JDeviceForest
from tpumcia.pipeline.run import run_pipeline as jax_run_pipeline
from tpumcia_torch.config import HeadConfig, ImportanceConfig
from tpumcia_torch.features import registry
from tpumcia_torch.features.extract import FeatureMatrix
from tpumcia_torch.importance import mdi
from tpumcia_torch.importance import permutation as perm
from tpumcia_torch.importance.channels import channel_importance
from tpumcia_torch.models import forest_device, forest_fit
from tpumcia_torch.models.forest_device import DeviceForest
from tpumcia_torch.models.heads import LogisticHead, RandomForestHead, fit_head
from tpumcia_torch.models.scaler import MinMaxScaler
from tpumcia_torch.pipeline.run import run_pipeline
from tpumcia_torch.utils import profiling

TREES_A_FIT = 8
TREE_ARRAYS = ("children_left", "children_right", "feature", "threshold", "value", "impurity",
               "n_node_samples", "weighted_n_node_samples")


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
    """A feature order per node that visits sklearn's chosen feature first:
    with every feature visited (max_features=F), the grower then reproduces
    sklearn's tree exactly when sklearn's choice is a first maximum of the
    Gini proxy, and ties between features (a two-row node splits the same
    way on every feature) break as sklearn's random order broke them. Nodes
    are keyed by depth, left to right, as the grower asks for them."""
    by_depth, frontier = [], [0]
    while frontier:
        by_depth.append([int(tree_.feature[n]) for n in frontier])
        frontier = [c for n in frontier if tree_.children_left[n] != -1
                    for c in (tree_.children_left[n], tree_.children_right[n])]

    def orders(tree, depth, n):
        out = np.tile(np.arange(num_features), (n, 1))
        for i, f in enumerate(by_depth[depth][:n] if depth < len(by_depth) else []):
            if f >= 0:
                out[i] = [f] + [g for g in range(num_features) if g != f]
        return torch.from_numpy(out)

    return orders


def _assert_tree_equal(got, want):
    for name in ("children_left", "children_right", "feature", "n_node_samples"):
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_array_equal(got.threshold, np.asarray(want.threshold))  # bit-equal
    for name in ("value", "impurity", "weighted_n_node_samples"):
        np.testing.assert_allclose(getattr(got, name), np.asarray(getattr(want, name)),
                                   rtol=0, atol=1e-12, err_msg=name)
    assert got.max_depth == want.max_depth


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("max_depth", [None, 4])
def test_grower_reproduces_sklearn_trees(seed, max_depth):
    """The port's grower against ``DecisionTreeClassifier(max_features=None)``
    with the same bootstrap counts as ``sample_weight``."""
    X, y, w = _gaussian(seed)
    sk = DecisionTreeClassifier(max_depth=max_depth, random_state=seed).fit(X, y, sample_weight=w)
    got = forest_fit.grow_trees(
        torch.from_numpy(X), torch.from_numpy(y), 3, torch.from_numpy(w)[None],
        max_depth=max_depth, max_features=X.shape[1],
        feature_orders=_sklearn_orders(sk.tree_, X.shape[1]),
    )
    assert len(got) == 1 and got[0].node_count == sk.tree_.node_count > 20
    _assert_tree_equal(got[0], sk.tree_)


def test_grower_chunks_trees_without_changing_them():
    """Several trees grown in one chunk or one per chunk are the same trees."""
    X, y, _ = _gaussian(3, n=120)
    rng = np.random.default_rng(3)
    w = torch.from_numpy(np.stack([np.bincount(rng.integers(0, 120, 120), minlength=120)
                                   for _ in range(5)]).astype(np.float64))

    def grow(chunk):
        gens = [torch.Generator().manual_seed(t) for t in range(5)]
        return forest_fit.grow_trees(torch.from_numpy(X), torch.from_numpy(y), 3, w, max_depth=None,
                                     max_features=3, feature_orders=forest_fit.RandomOrders(gens, 10),
                                     chunk_elems=chunk)

    for a, b in zip(grow(1 << 30), grow(1)):
        for name in TREE_ARRAYS:
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


class _RecordingOrders(forest_fit.RandomOrders):
    """``RandomOrders`` that keeps each call's (tree, depth, n)."""

    def __init__(self, generators, num_features):
        super().__init__(generators, num_features)
        self.calls = []

    def __call__(self, tree, depth, n):
        self.calls.append((tree, depth, n))
        return super().__call__(tree, depth, n)


def _five_trees(orders_of, chunk):
    """Five trees on 120 rows and 10 features, the orders from
    ``orders_of(generators, num_features)``, ``chunk_elems=chunk``."""
    X, y, _ = _gaussian(3, n=120)
    rng = np.random.default_rng(3)
    w = torch.from_numpy(np.stack([np.bincount(rng.integers(0, 120, 120), minlength=120)
                                   for _ in range(5)]).astype(np.float64))
    orders = orders_of([torch.Generator().manual_seed(t) for t in range(5)], 10)
    trees = forest_fit.grow_trees(torch.from_numpy(X), torch.from_numpy(y), 3, w, max_depth=None,
                                  max_features=3, feature_orders=orders, chunk_elems=chunk)
    return trees, orders


def _nodes_by_depth(tree):
    """Each depth's node count of a fitted tree."""
    depth = np.zeros(tree.node_count, np.int64)
    for i in range(tree.node_count):  # a parent comes before its children
        for c in (tree.children_left[i], tree.children_right[i]):
            if c != forest_fit.TREE_LEAF:
                depth[c] = depth[i] + 1
    return np.bincount(depth)


@pytest.mark.parametrize("per_chunk", [5, 2])  # one chunk; three (2 + 2 + 1 trees)
def test_orders_are_drawn_level_by_level_in_tree_order(per_chunk):
    """The draws, now made while the device works, come as before: chunk by
    chunk, level by level, each level's trees in order, each tree asked at
    depths 0, 1, 2, ... for its node count there; the trees equal a plain
    ``RandomOrders`` fit's."""
    trees, orders = _five_trees(_RecordingOrders, per_chunk * 10 * 120)
    plain, _ = _five_trees(forest_fit.RandomOrders, 1 << 30)
    for a, b in zip(trees, plain):
        for name in TREE_ARRAYS:
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    want = []
    for t0 in range(0, 5, per_chunk):
        counts = [_nodes_by_depth(t) for t in trees[t0:t0 + per_chunk]]
        for depth in range(max(len(c) for c in counts)):
            want += [(t0 + i, depth, int(c[depth])) for i, c in enumerate(counts) if depth < len(c)]
    assert orders.calls == want
    assert max(d for _, d, _ in want) > 3


@pytest.mark.parametrize("per_chunk", [TREES_A_FIT, 3])
def test_the_fit_waits_once_a_level(per_chunk, monkeypatch):
    """``fit_forest`` reads the device back once a level: the counter of its
    waits equals the levels grown, in one chunk or in three."""
    X, y, _ = _gaussian(5, n=150)
    monkeypatch.setattr(forest_fit, "grow_trees", functools.partial(
        forest_fit.grow_trees, chunk_elems=per_chunk * X.size))
    profiling.reset_counters()
    trees = forest_fit.fit_forest(torch.from_numpy(X), torch.from_numpy(y), 3, n_estimators=TREES_A_FIT,
                                  max_depth=None, seed=11)
    levels = sum(max(t.max_depth for t in trees[i:i + per_chunk]) + 1
                 for i in range(0, TREES_A_FIT, per_chunk))
    assert profiling.COUNTERS["forest_levels"] == levels > 5
    assert profiling.COUNTERS["forest_fit_waits"] == profiling.COUNTERS["forest_levels"]


def test_the_fit_reads_no_tensor_back_but_its_records(monkeypatch):
    """Inside ``grow_trees`` no tensor's value reaches the host but through
    the level's records: no ``item``, ``tolist``, ``cpu``, ``int()``,
    ``float()``, ``bool()``, ``nonzero``, ``bincount``,
    ``repeat_interleave`` or boolean-mask index (each a wait on the card);
    the trees are those of an unguarded fit."""
    def refused(name):
        def refuse(*args, **kwargs):
            raise AssertionError(f"{name} inside the forest fit")
        return refuse

    def fit():
        return _five_trees(forest_fit.RandomOrders, 2 * 10 * 120)[0]

    want = fit()
    for name in ("item", "tolist", "cpu", "nonzero", "__int__", "__float__", "__bool__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refused(name))
    for name in ("bincount", "repeat_interleave", "nonzero", "masked_select"):
        monkeypatch.setattr(torch, name, refused(name))
    getitem = torch.Tensor.__getitem__

    def no_mask(self, index):
        parts = index if isinstance(index, tuple) else (index,)
        assert not any(isinstance(p, torch.Tensor) and p.dtype == torch.bool for p in parts), "a mask index"
        return getitem(self, index)

    monkeypatch.setattr(torch.Tensor, "__getitem__", no_mask)
    got = fit()
    monkeypatch.undo()
    for a, b in zip(got, want):
        for name in TREE_ARRAYS:
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def test_feature_visits_continue_past_constant_features():
    """sklearn's visit rule: after ``max_features`` visits the node stops,
    unless every feature visited so far was constant in it."""
    rng = np.random.default_rng(0)
    y = np.repeat([0, 1], 20)
    X = np.zeros((40, 4), np.float32)
    X[:, 2] = y + 0.1 * rng.random(40)  # separates the classes
    X[:, 3] = rng.random(40)  # a weaker split
    w = torch.ones((1, 40), dtype=torch.float64)

    def root_feature(order):
        trees = forest_fit.grow_trees(
            torch.from_numpy(X), torch.from_numpy(y), 2, w, max_depth=1, max_features=1,
            feature_orders=lambda t, d, n: torch.tensor([order] * n),
        )
        return int(trees[0].feature[0])

    assert root_feature([0, 1, 3, 2]) == 3  # two constants, then one visit
    assert root_feature([0, 1, 2, 3]) == 2
    assert root_feature([3, 2, 0, 1]) == 3  # one visit only


@pytest.fixture(scope="module")
def sk_head():
    """A tpumcia forest head (sklearn's fit) on a small 3-channel matrix, its
    training rows and the held-out rows."""
    rng = np.random.default_rng(7)
    n, channels = 240, 3
    y = rng.integers(0, 3, n)
    X = rng.normal(size=(n, 23 * channels)).astype(np.float32)
    X[:, 0] += 1.5 * y
    X[:, 17 * channels] -= 1.0 * y
    head = jheads.fit_head(X[:160], y[:160], config=JHeadConfig(kind="random_forest", n_estimators=8))
    return head, X, y


def _port_of(head, device="cpu"):
    scaler = MinMaxScaler.from_stats(head.scaler.data_min, head.scaler.data_max, device=device)
    return RandomForestHead.from_sklearn(head.model, scaler=scaler, config=HeadConfig(kind="random_forest"),
                                         device=device)


_jax_apply_gemm = jax.jit(jforest_device._apply_gemm)
_jax_apply_lockstep = jax.jit(jforest_device._apply_lockstep)  # depth traced: any bound >= depth holds


def _jax_lockstep(forest, X):
    """tpumcia's lock-step descent of its padded forest arrays."""
    return np.asarray(_jax_apply_lockstep(
        forest.feature, forest.threshold, forest.left, forest.right, forest.leaf_proba, forest.depth,
        jnp.asarray(X)))


def test_sklearn_forest_carried_across(sk_head):
    head, X, y = sk_head
    port = _port_of(head)
    for got, est in zip(port.trees, head.model.estimators_):
        _assert_tree_equal(got, est.tree_)
    f = port.to_device()
    assert f.nodes.shape == (sum(t.node_count for t in port.trees), 4) and f.roots.shape == (8,)
    # the port's walk, on apply and on predict_proba, against tpumcia's
    # DeviceForest (its GEMM form) and its lock-step form: equal, every leaf
    # being pure
    want = JDeviceForest.from_sklearn(head.model, head.classes, head.scaler)
    assert want.gemm is not None
    Xs = np.asarray(head.scaler.transform(X))
    proba = port.predict_proba(X).numpy()
    np.testing.assert_array_equal(f.apply(torch.tensor(Xs)).numpy(), proba)
    np.testing.assert_array_equal(proba, np.asarray(want.predict_proba(X)))
    np.testing.assert_array_equal(proba, _jax_lockstep(want, Xs))
    # sklearn's probabilities and labels
    np.testing.assert_allclose(proba, head.model.predict_proba(Xs), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(port.predict(X), head.predict(X))
    assert port.score(X[160:], y[160:]) == head.score(X[160:], y[160:])
    # MDI
    np.testing.assert_allclose(port.mdi_importance(), head.model.feature_importances_, rtol=0, atol=1e-12)
    np.testing.assert_allclose(mdi.mdi_importance(port), head.mdi_importance(), rtol=0, atol=1e-12)


def test_walk_equals_tpumcias_lockstep_forest(sk_head, monkeypatch):
    """Past ``_GEMM_MAX_CELLS`` tpumcia lays a forest out for its lock-step
    descent only; the port's one walk scores it alike."""
    head, X, _ = sk_head
    monkeypatch.setattr(jforest_device, "_GEMM_MAX_CELLS", 4)
    want = JDeviceForest.from_sklearn(head.model, head.classes, head.scaler)
    assert want.gemm is None
    np.testing.assert_array_equal(_port_of(head).predict_proba(X).numpy(),
                                  np.asarray(want.predict_proba(X)))


# every walk case is scored by tpumcia's forms at one shape, so each form
# compiles once: padding adds internal nodes with zero path columns, leaves
# that target -1 (never reached), nodes no child points at, and zero classes
# and rows, which are cut from the result
_PAD_INTERNAL, _PAD_NODES = 32, 64
_PAD_CLASSES = max(c[0] for c in WALK_CASES.values())
_PAD_ROWS = (WALK_FEATURES * WALK_REPEATS + 1) * WALK_ROWS


def _pad(a, *shape, value=0):
    a = np.asarray(a)
    return np.pad(a, [(0, s - d) for d, s in zip(a.shape, shape)], constant_values=value)


def _jax_forest(trees, classes):
    """tpumcia's DeviceForest of duck-typed trees (``random_tree``)."""
    model = SimpleNamespace(
        estimators_=[SimpleNamespace(tree_=SimpleNamespace(**vars(t), node_count=len(t.feature)))
                     for t in trees],
        n_classes_=classes, classes_=np.arange(classes))
    return JDeviceForest.from_sklearn(model)


@pytest.mark.parametrize("case", sorted(WALK_CASES))
def test_walk_reads_permuted_columns_in_place(case):
    """The walk kernel's plain version (``apply_permuted`` on the CPU)
    against each draw's permuted copy ``torch.where(permuted, X[perm], X)``
    scored by tpumcia's GEMM and lock-step forms, and the unpermuted walk
    (``apply``) against both: equal with pure leaves (integer sums over T),
    within 1e-6 with impure ones (the trees summed in another order)."""
    trees, X, masks = walk_case(case)
    classes, pure, _, extra = WALK_CASES[case]
    f = DeviceForest.from_arrays(trees, np.arange(classes), device="cpu")
    want = _jax_forest(trees, classes)
    assert want.gemm is not None and want.depth == max(t.max_depth for t in trees)
    assert (want.depth > 19) == (extra == "chain") and bool(X.isnan().any()) == (extra == "nan")
    G = masks.shape[0]
    perms = perm.draw_permutations(G * WALK_REPEATS, WALK_ROWS, seed=3, device="cpu")
    group_of = torch.arange(G).repeat_interleave(WALK_REPEATS)
    copies = torch.where(masks[group_of].bool()[:, None, :], X[perms], X)
    got = f.apply_permuted(X, perms, masks, WALK_REPEATS)
    base = f.apply(X)
    assert got.shape == (G * WALK_REPEATS, WALK_ROWS, classes) and base.shape == (WALK_ROWS, classes)
    T, K, I, N = len(trees), _PAD_CLASSES, _PAD_INTERNAL, _PAD_NODES
    g_feature, g_threshold, A, target, g_proba = want.gemm
    gemm = (_pad(g_feature, T, I), _pad(g_threshold, T, I), _pad(A, T, I + 1, I),
            _pad(target, T, I + 1, value=-1), _pad(g_proba, T, I + 1, K))
    lock = (*(_pad(a, T, N) for a in (want.feature, want.threshold, want.left, want.right)),
            _pad(want.leaf_proba, T, N, K), want.depth)
    forms = {"gemm": lambda x: _jax_apply_gemm(*gemm, x), "lockstep": lambda x: _jax_apply_lockstep(*lock, x)}
    rows = torch.cat([copies.reshape(-1, WALK_FEATURES), X]).numpy()  # every draw's rows, then X
    for form, score in forms.items():
        wanted = np.asarray(score(_pad(rows, _PAD_ROWS, WALK_FEATURES)))[:len(rows), :classes]
        pairs = ((got.numpy(), wanted[:-WALK_ROWS].reshape(got.shape)), (base.numpy(), wanted[-WALK_ROWS:]))
        for w, v in pairs:
            if pure:
                np.testing.assert_array_equal(w, v, err_msg=form)
            else:
                np.testing.assert_allclose(w, v, rtol=0, atol=1e-6, err_msg=form)


def test_walk_layout_refuses_a_child_before_its_parent():
    tree = random_tree(np.random.default_rng(0), splits=3, features=4, classes=2, pure=True)
    f = DeviceForest.from_arrays([tree], np.arange(2), device="cpu")
    nodes, roots, values, n_features = f.nodes, f.roots, f.values, f.n_features
    assert nodes.shape == (7, 4) and roots.tolist() == [0] and values.shape[0] <= 2 and n_features <= 4
    tree.children_left[0], tree.children_right[0] = 0, tree.children_right[0]
    with pytest.raises(ValueError, match="not after its parent"):
        DeviceForest.from_arrays([tree], np.arange(2), device="cpu")


def test_sweep_hands_the_kernel_its_permutations_and_masks(sk_head, monkeypatch):
    """A forest head's scorer gives the sweep its outputs itself. On a CUDA
    forest (its device faked, the kernel's plain version in the kernel's
    place) that is the baseline, then one launch per chunk of whole groups;
    the drops and share drops equal those of the same scorer as a plain
    callable, scored on permuted copies."""
    head, X, y = sk_head
    scorer, classes = perm._device_score_parts(_port_of(head))
    assert scorer.probabilities
    groups = registry.columns_by_channel_positional(3)
    Xt = torch.from_numpy(X[160:])
    y_idx = torch.from_numpy(perm.labels_to_class_idx(y[160:], classes)).long()
    masks = torch.from_numpy(perm.group_masks(groups, X.shape[1]))
    perms = perm.draw_permutations(3 * 3, 80, seed=5, device="cpu").reshape(3, 3, 80)
    want = perm._perm_sweep(Xt, y_idx, masks, perms, lambda x: scorer(x), shares=True)
    launches = []

    def plain_kernel(X, perms, masks, repeats, nodes, roots, values, n_features):
        launches.append(None if perms is None else (perms.shape[0], masks.shape[0], masks.dtype))
        return forest_device._apply_walk(X, nodes, roots, values, perms, masks, repeats)

    monkeypatch.setattr(forest_device, "_launch_walk", plain_kernel)
    monkeypatch.setattr(DeviceForest, "device", property(lambda self: torch.device("cuda")))
    monkeypatch.setattr(perm, "_SWEEP_CHUNK_ELEMS", 2 * 3 * 80 * 3)  # two groups a launch
    got = perm._perm_sweep(Xt, y_idx, masks, perms, scorer, shares=True)
    assert launches == [None, (6, 2, torch.uint8), (3, 1, torch.uint8)]
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_a_logistic_sweep_takes_no_forest_branch(monkeypatch):
    """``_perm_sweep`` over a logistic head scores its permuted copies as
    before: importances bit-equal to each draw's ``torch.where`` copy scored
    by ``_scaled_logistic_apply``, ``_SWEEP_CHUNK_ELEMS // (N * F)`` draws
    at a time, and no forest is asked."""
    X, y = _graded_matrix(120, 5)
    lg = fit_head(X[:80], y[:80], device="cpu", config=HeadConfig(num_steps=10))
    apply_fn, classes = perm._device_score_parts(lg)
    assert not hasattr(apply_fn, "sweep_outputs") and not getattr(apply_fn, "probabilities", False)

    def refuse(*args, **kwargs):
        raise AssertionError("a logistic sweep reached the forest")

    monkeypatch.setattr(DeviceForest, "apply_permuted", refuse)
    monkeypatch.setattr(forest_device, "_launch_walk", refuse)
    monkeypatch.setattr(perm, "_SWEEP_CHUNK_ELEMS", 7 * 40 * 69)  # 7 draws a chunk
    got = perm.permutation_importance(lg, X[80:], y[80:], n_repeats=2, seed=1)
    assert got.share_importances is None

    Xt = torch.from_numpy(X[80:])
    N, F, R = Xt.shape[0], Xt.shape[1], 2
    y_idx = torch.from_numpy(perm.labels_to_class_idx(y[80:], classes)).long()
    perms = perm.draw_permutations(F * R, N, seed=1, device="cpu")
    permuted = torch.eye(F)[torch.arange(F).repeat_interleave(R)].bool()[:, None, :]

    def accuracy(rows):
        out = perm._scaled_logistic_apply(lg.params, lg.scaler.data_min, lg.scaler.scale, rows)
        return (torch.argmax(out, dim=-1) == y_idx).to(torch.float32).mean(-1)

    step = perm._SWEEP_CHUNK_ELEMS // (N * F)
    scores = torch.cat([accuracy(torch.where(permuted[s:s + step], Xt[perms[s:s + step]], Xt))
                        for s in range(0, F * R, step)])
    want = (accuracy(Xt) - scores.reshape(F, R)).numpy().astype(np.float64)
    assert got.baseline_score == float(accuracy(Xt))
    np.testing.assert_array_equal(got.importances, want)


@pytest.mark.parametrize("grouped", [False, True])
def test_forest_sweep_matches_jax(sk_head, grouped, monkeypatch):
    """The device sweep over the forest with JAX's permutations replayed:
    drops equal to tpumcia's ``_perm_sweep`` over its ``DeviceForest``."""
    head, X, y = sk_head
    replay_jax_draws(monkeypatch)
    groups = registry.columns_by_channel_positional(3) if grouped else None
    want = jperm.permutation_importance(head, X[160:], y[160:], n_repeats=3, seed=5, groups=groups)
    got = perm.permutation_importance(_port_of(head), X[160:], y[160:], n_repeats=3, seed=5, groups=groups)
    assert got.baseline_score == want.baseline_score
    np.testing.assert_allclose(got.importances, np.asarray(want.importances), rtol=0, atol=1.2e-7)


def test_host_sweep_matches_sklearns(sk_head):
    """``permutation_importance_host`` (numpy) against tpumcia's, which calls
    sklearn's ``permutation_importance``: the same shuffles, the same
    scores."""
    head, X, y = sk_head
    want = jperm.permutation_importance_host(head, X[160:], y[160:], n_repeats=3, seed=4)
    port = _port_of(head)
    got = perm.permutation_importance_host(port, X[160:], y[160:], n_repeats=3, seed=4)
    assert got.baseline_score == want.baseline_score
    np.testing.assert_array_equal(got.importances, want.importances)
    np.testing.assert_array_equal(got.importances_std, want.importances_std)
    # the host sweep takes any head with score(), a logistic one too
    lg = fit_head(X[:160], y[:160], device="cpu", config=HeadConfig(num_steps=20))
    res = perm.permutation_importance_host(lg, X[160:], y[160:], n_repeats=2, seed=4)
    assert res.importances.shape == (X.shape[1], 2)


def _graded_matrix(n, seed):
    """(n, 69) features of 3 channels: channel 0 carries the label strongly,
    channel 1 weakly, channel 2 not at all."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, n)
    X = rng.normal(size=(n, 69)).astype(np.float32)
    ch = registry.columns_by_channel_positional(3)
    X[:, ch[0][:4]] += 2.0 * y[:, None]
    X[:, ch[1][:2]] += 0.6 * y[:, None]
    return X, y


def test_port_forest_against_tpumcias():
    """The port's own forest (its fit, its random streams) against tpumcia's
    sklearn forest on the same matrix: accuracy within 0.05, the MDI and
    permutation channel rankings equal, the signal channel first."""
    X, y = _graded_matrix(400, 1)
    tr, te = slice(0, 300), slice(300, 400)
    jh = jheads.fit_head(X[tr], y[tr], config=JHeadConfig(kind="random_forest", n_estimators=40))
    th = fit_head(X[tr], y[tr], device="cpu", config=HeadConfig(kind="random_forest", n_estimators=40))
    assert isinstance(th, RandomForestHead) and len(th.trees) == 40
    assert abs(th.score(X[te], y[te]) - jh.score(X[te], y[te])) <= 0.05
    for method in ("mdi", "permutation"):
        want = jchannels.channel_importance(jh, _jfm(X[te]), y[te], method=method,
                                            config=JImportanceConfig(n_repeats=5))
        got = channel_importance(th, _fm(X[te]), y[te], method=method, config=ImportanceConfig(n_repeats=5))
        assert got.method == want.method == method
        assert got.ranking.tolist() == want.ranking.tolist() == [0, 1, 2], (method, got.total, want.total)
    auto = channel_importance(th, _fm(X[te]), y[te])
    assert auto.method == "mdi"
    np.testing.assert_allclose(auto.total.sum(), th.mdi_importance()[th.mdi_importance() > 0.01].sum())


def _fm(X):
    return FeatureMatrix(values=X, names=registry.feature_names(3), num_channels=3)


def _jfm(X):
    from tpumcia.features import registry as jregistry
    from tpumcia.features.extract import FeatureMatrix as JFeatureMatrix

    return JFeatureMatrix(values=X, names=jregistry.feature_names(3), num_channels=3, degenerate=None)


def test_same_seed_same_forest():
    X, y = _graded_matrix(150, 2)
    cfg = HeadConfig(kind="random_forest", n_estimators=6, seed=3)
    a, b = (fit_head(X, y, device="cpu", config=cfg) for _ in range(2))
    c = fit_head(X, y, device="cpu", config=HeadConfig(kind="random_forest", n_estimators=6, seed=4))
    for ta, tb in zip(a.trees, b.trees):
        for name in TREE_ARRAYS:
            np.testing.assert_array_equal(getattr(ta, name), getattr(tb, name))
    assert any(not np.array_equal(ta.feature, tc.feature) for ta, tc in zip(a.trees, c.trees))
    np.testing.assert_allclose(a.mdi_importance().sum(), 1.0, rtol=0, atol=1e-12)


def test_forest_checkpoint_round_trip(tmp_path):
    X, y = _graded_matrix(120, 3)
    head = fit_head(X, y * 5 + 1, device="cpu",
                    config=HeadConfig(kind="random_forest", n_estimators=5, max_depth=6, seed=9))
    head.save(tmp_path / "rf.npz")
    back = RandomForestHead.load(tmp_path / "rf.npz", device="cpu")
    assert back.config == head.config and back.num_features == 69
    np.testing.assert_array_equal(back.classes, head.classes)
    for ta, tb in zip(head.trees, back.trees):
        for name in TREE_ARRAYS:
            np.testing.assert_array_equal(getattr(ta, name), getattr(tb, name))
        assert ta.max_depth == tb.max_depth <= 6
    np.testing.assert_array_equal(back.predict(X), head.predict(X))
    torch.testing.assert_close(back.scaler.data_max, head.scaler.data_max)
    np.testing.assert_array_equal(back.mdi_importance(), head.mdi_importance())


def test_restored_forest_and_scaler_default_to_the_card():
    """Like the other heads' ``load``, the forest's ``load``, ``from_sklearn``
    and ``fit``'s tensors follow the rule that the port runs on the card
    unless asked; ``MinMaxScaler.from_stats`` too."""
    for fn in (RandomForestHead.load, RandomForestHead.from_sklearn, DeviceForest.from_arrays,
               DeviceForest.from_sklearn, MinMaxScaler.from_stats):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    s = MinMaxScaler.from_stats([0.0, 1.0], [2.0, 3.0], device="cpu")
    assert s.data_min.device.type == "cpu" and s.data_min.dtype == torch.float32


def test_mdi_needs_a_forest():
    X, y = _graded_matrix(80, 4)
    lg = fit_head(X, y, device="cpu", config=HeadConfig(num_steps=5))
    assert isinstance(lg, LogisticHead)
    with pytest.raises(TypeError, match="forests"):
        mdi.mdi_importance(lg)
    rf = fit_head(X, y, device="cpu", config=HeadConfig(kind="random_forest", n_estimators=3))
    out = mdi.mdi_channel_importance(rf, _fm(X))
    assert out.method == "mdi" and out.ranking[0] == 0


def _graded_images(n_per_class, seed):
    """(N, 24, 24, 3) uint8 images of 2 classes on N(80, 20) backgrounds:
    channel 0 a bright blob in class 1, channel 1 a mean shift of 4 levels
    in class 1 (weaker), channel 2 constant (no signal, ties at 0)."""
    rng = np.random.default_rng(seed)
    n = 2 * n_per_class
    labels = np.repeat([0, 1], n_per_class)
    yy, xx = np.mgrid[:24, :24]
    blob = np.exp(-((yy - 12) ** 2 + (xx - 12) ** 2) / 30.0)
    x = rng.normal(80, 20, size=(n, 24, 24, 3))
    x[..., 0] += 120 * blob[None] * labels[:, None, None]
    x[..., 1] += 4 * labels[:, None, None]
    x[..., 2] = 7
    order = rng.permutation(n)
    return np.clip(x, 0, 255).astype(np.uint8)[order], labels[order]


@pytest.mark.parametrize("channel_method", ["auto", "mdi", "permutation"])
def test_classic_slice_with_the_forest_matches_jax(channel_method, monkeypatch):
    """``run_pipeline`` with ``head.kind='random_forest'`` on a CPU device
    against tpumcia's (sklearn's forest): the same split, the same channel
    ranking in both views, MDI as the feature view."""
    images, labels = _graded_images(40, 0)
    replay_jax_draws(monkeypatch)
    cfg = {"head": {"kind": "random_forest", "n_estimators": 30}, "batch_size": 64,
           "split": {"stratify": True}, "importance": {"channel_method": channel_method, "n_repeats": 4}}
    want = jax_run_pipeline(images, labels, config=cfg)
    got = run_pipeline(images, labels, config=cfg, device="cpu")
    np.testing.assert_array_equal(got.test_idx, want.test_idx)
    assert isinstance(got.head, RandomForestHead)
    assert got.feature_result.method == want.feature_result.method == "mdi"
    assert got.channel_result.method == want.channel_result.method
    assert got.channel_result.ranking.tolist() == want.channel_result.ranking.tolist()
    assert got.feature_result.ranking.tolist() == want.feature_result.ranking.tolist() == [0, 1, 2]
    assert got.channel_result.ranking[0] == 0
    assert abs(got.test_accuracy - want.test_accuracy) <= 0.1 and got.test_accuracy >= 0.9
