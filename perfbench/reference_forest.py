"""The plain reference of the ``forest`` entry: the reference notebook's own
model, sklearn's ``RandomForestClassifier()`` with every default (100 trees,
Gini, ``max_features='sqrt'``, bootstrap, no depth cap; Breiman 2001), fitted
on the MinMax-scaled training rows, and both of the notebook's importance
views of it: MDI (``feature_importances_``) and the per-feature permutation
importance on the test rows (``permutation_importance(model, X_test, y_test,
n_repeats=10, random_state=42)``).

Plain ``torch`` in float64 with TF32 off: one tree at a time, one node at a
time, no chunking of trees, no segmented tensors, no GEMM form. It imports
nothing of the program. Each tree follows sklearn's published rules:

- the bootstrap: n draws of a row with replacement; their counts are the
  rows' integer sample weights, and a row of weight 0 takes no part in the
  tree (so every split sum is an exact integer in float64, in any order);
- Gini on the weighted class counts; a node is a leaf at the depth cap, with
  fewer than 2 rows, when pure (impurity <= float64 eps), when it has no
  valid split, or when its best split's improvement + eps < 0;
- ``max_features = max(1, int(sqrt(F)))`` features visited in the node's
  random order, going on past that many while every feature visited so far
  is constant in the node (``x_max <= x_min + 1e-7`` in float32, sklearn's
  ``FEATURE_THRESHOLD``);
- a split position between neighbours in sorted order where ``x[p] > x[p-1]
  + 1e-7`` (float32); the threshold ``x[p-1]/2 + x[p]/2`` in float64
  (``x[p-1]`` where that is ``x[p]`` or infinite); the largest Gini proxy
  ``-w_r * imp_r - w_l * imp_l``, ties to the first feature in visit order,
  then to the first position;
- the tree in the arrays of sklearn's ``tree_``, nodes numbered depth first
  (a node, its left subtree, its right), each node's value its weighted
  class fractions.

Departures from sklearn (the port makes the same two; none from the port):

- the random streams: tree ``t`` draws from a CPU ``torch.Generator``
  seeded with :func:`synth_batch_seed` ``(seed, t)``: first the bootstrap
  (``randint(0, n, (n,))``), then at each depth of the tree one (nodes at
  that depth, F) block of float64 uniforms, whose stable argsort along a row
  is a node's visit order, nodes left to right. sklearn's streams are not
  reproduced;
- growth breadth first within a tree, so that the draws come depth by depth;
  sklearn grows depth first. The order of growth changes no split.

Around the trees:

- the scaling, fitted on the training rows in float32 as the configuration
  states the matrix: ``(x - min) * (1 / (max - min))``, a zero range scaled
  by 1;
- a row's class shares: every tree walked to its leaf, the float64 leaf
  fractions averaged; the predicted class is the first of the largest;
- the sweep: ``F * n_repeats`` permutations of the test rows, the argsort
  of as many rows of float64 uniforms from a generator on the scoring device
  seeded with the importance seed, ``n_repeats`` a column in column order;
  a column's drop is the baseline accuracy less the accuracy with that
  column's values permuted, averaged over its repeats; each permutation's
  share drop is the baseline's mean share of the true class less the
  permuted copy's (a drop that moves where no vote turns).

``control`` computes one precision step below: ``"f32"`` the split sums,
impurities, improvements and MDI in float32; ``"bf16_shares"`` the class
shares averaged in bfloat16.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

FEATURE_THRESHOLD = 1e-7  # sklearn's tie tolerance, a float32 constant there
EPSILON = float(np.finfo(np.float64).eps)
TREE_LEAF = -1
TREE_UNDEFINED = -2
CONTROLS = ("f32", "bf16_shares")
SCORE_ROWS = 1 << 20  # permuted test rows walked through the forest at once
# the arrays of a tree that a comparison of two forests reads
TREE_FIELDS = ("children_left", "children_right", "feature", "threshold", "n_node_samples",
               "weighted_n_node_samples")


def synth_batch_seed(seed: int, index: int) -> int:
    """numpy's SeedSequence of (seed, index): the seed of tree ``index``'s
    generator."""
    return int(np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0])


@contextlib.contextmanager
def _no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


# ---- the trees ---------------------------------------------------------------

def _best_split(x, wy, tot, W, total_w, imp, order, max_features):
    """A node's split: ``x`` (n, F) float32 rows, ``wy`` (n, K) their
    weighted class counts, ``tot`` (K,) and ``W`` the node's class totals and
    weight, ``imp`` its impurity, ``order`` its visit order. Returns
    (feature, threshold) or None."""
    F = x.shape[1]
    thr32 = torch.tensor(FEATURE_THRESHOLD, dtype=torch.float32)
    nonconst = x.amax(0) > x.amin(0) + thr32
    rank = torch.empty_like(order)
    rank[order] = torch.arange(F)
    first_nc = int(torch.where(nonconst, rank, F).min())
    visits = min(max(max_features, first_nc + 1), F)
    cand = [int(f) for f in order[:visits] if nonconst[f]]
    if not cand:
        return None
    srt, idx = torch.sort(x[:, cand], dim=0, stable=True)  # (n, C)
    left = torch.cumsum(wy[idx], 0)[:-1]  # (n - 1, C, K): the first p rows, p = 1 .. n - 1
    right = tot - left
    w_l = left.sum(-1)
    w_r = W - w_l
    sq_l = (left * left).sum(-1)
    sq_r = (right * right).sum(-1)
    valid = srt[1:] > srt[:-1] + thr32
    one = torch.ones((), dtype=w_l.dtype)
    wl_safe, wr_safe = torch.where(valid, w_l, one), torch.where(valid, w_r, one)
    imp_l = 1.0 - sq_l / (wl_safe * wl_safe)
    imp_r = 1.0 - sq_r / (wr_safe * wr_safe)
    proxy = torch.where(valid, -w_r * imp_r - w_l * imp_l, -torch.inf).t().flatten()
    top = proxy.max()
    if top == -torch.inf:
        return None
    c, p = divmod(int(torch.nonzero(proxy == top)[0]), len(srt) - 1)
    a, b = float(srt[p, c]), float(srt[p + 1, c])  # float32 values, exact as float64
    thr = a / 2.0 + b / 2.0
    if thr == b or np.isinf(thr):
        thr = a
    il, ir = imp_l[p, c], imp_r[p, c]
    wl_c, wr_c = w_l[p, c], w_r[p, c]
    improvement = (W / total_w) * (imp - (wr_c / W * ir) - (wl_c / W * il))
    if improvement + EPSILON < 0.0:
        return None
    return cand[c], thr


def grow_tree(X, y, num_classes, weights, orders, *, max_features, max_depth=None,
              dtype=torch.float64) -> dict:
    """One tree on ``X`` ((N, F) float32), ``y`` ((N,) int64 class indices)
    and ``weights`` ((N,) integer counts), all on the CPU; ``orders(depth,
    n)`` gives the (n, F) visit orders of the tree's n nodes at ``depth``,
    left to right; the sums in ``dtype``. Returns sklearn's ``tree_`` arrays
    (numpy) and ``max_depth``."""
    n, F = X.shape
    cap = np.inf if max_depth is None else max_depth
    w = weights.to(dtype)
    wy = torch.nn.functional.one_hot(y, num_classes).to(dtype) * w[:, None]
    total_w = w.sum()
    nodes = []  # breadth first: depth, rows, value, impurity, weight, split, children
    level = [torch.nonzero(weights > 0).flatten()]
    depth = 0
    while level:
        first_next = len(nodes) + len(level)
        nxt = []
        for rows, order in zip(level, orders(depth, len(level))):
            tot = wy[rows].sum(0)
            W = tot.sum()
            imp = 1.0 - (tot * tot).sum() / (W * W)
            split = None
            if not (depth >= cap or len(rows) < 2 or imp <= EPSILON):
                split = _best_split(X[rows], wy[rows], tot, W, total_w, imp, order, max_features)
            node = {"depth": depth, "n": len(rows), "value": tot / W, "impurity": float(imp),
                    "weight": float(W), "split": split, "children": None}
            if split is not None:
                f, thr = split
                go_left = X[rows, f].double() <= thr
                node["children"] = (first_next + len(nxt), first_next + len(nxt) + 1)
                nxt += [rows[go_left], rows[~go_left]]
            nodes.append(node)
        level, depth = nxt, depth + 1
    return _preorder(nodes)


def _preorder(nodes) -> dict:
    """Breadth-first node records -> sklearn's arrays, numbered depth first."""
    order, stack = [], [0]
    while stack:
        i = stack.pop()
        order.append(i)
        if nodes[i]["children"] is not None:
            stack += [nodes[i]["children"][1], nodes[i]["children"][0]]
    pre = {b: k for k, b in enumerate(order)}
    recs = [nodes[i] for i in order]

    def child(r, side):
        return pre[r["children"][side]] if r["children"] is not None else TREE_LEAF

    return {
        "children_left": np.array([child(r, 0) for r in recs], np.int64),
        "children_right": np.array([child(r, 1) for r in recs], np.int64),
        "feature": np.array([r["split"][0] if r["split"] else TREE_UNDEFINED for r in recs],
                            np.int64),
        "threshold": np.array([r["split"][1] if r["split"] else float(TREE_UNDEFINED)
                               for r in recs], np.float64),
        "value": torch.stack([r["value"] for r in recs]).double().numpy()[:, None, :],
        "impurity": np.array([r["impurity"] for r in recs], np.float64),
        "n_node_samples": np.array([r["n"] for r in recs], np.int64),
        "weighted_n_node_samples": np.array([r["weight"] for r in recs], np.float64),
        "max_depth": max(r["depth"] for r in recs),
    }


def grow_forest(X, y, num_classes, *, n_estimators, max_depth, seed,
                dtype=torch.float64) -> list[dict]:
    """``n_estimators`` trees on ``X`` ((N, F) float32, CPU) and ``y`` ((N,)
    int64 class indices), tree ``t`` from its own generator (the module's
    docstring)."""
    n, F = X.shape
    max_features = max(1, int(np.sqrt(F)))
    trees = []
    for t in range(n_estimators):
        gen = torch.Generator().manual_seed(synth_batch_seed(seed, t))
        weights = torch.bincount(torch.randint(0, n, (n,), generator=gen), minlength=n)

        def orders(depth, count, gen=gen):
            u = torch.rand((count, F), generator=gen, dtype=torch.float64)
            return torch.argsort(u, dim=1, stable=True)

        trees.append(grow_tree(X, y, num_classes, weights, orders, max_features=max_features,
                               max_depth=max_depth, dtype=dtype))
    return trees


def mdi(trees, num_features: int, dtype=torch.float64) -> np.ndarray:
    """sklearn's ``feature_importances_``: per tree, each internal node's
    ``w * imp - w_l * imp_l - w_r * imp_r`` added to its feature, over the
    root's weight, normalised; the mean over the trees of more than one node,
    normalised."""
    per_tree = []
    for t in trees:
        if len(t["feature"]) <= 1:
            continue
        inner = torch.from_numpy(np.flatnonzero(t["children_left"] != TREE_LEAF))
        left = torch.from_numpy(t["children_left"])[inner]
        right = torch.from_numpy(t["children_right"])[inner]
        w = torch.from_numpy(t["weighted_n_node_samples"]).to(dtype)
        i = torch.from_numpy(t["impurity"]).to(dtype)
        drop = w[inner] * i[inner] - w[left] * i[left] - w[right] * i[right]
        imp = torch.zeros(num_features, dtype=dtype).index_add_(
            0, torch.from_numpy(t["feature"])[inner], drop) / w[0]
        total = imp.sum()
        per_tree.append(imp / total if total > 0 else imp)
    if not per_tree:
        return np.zeros(num_features)
    mean = torch.stack(per_tree).mean(0)
    return (mean / mean.sum()).double().numpy()


# ---- the class shares and the sweep ------------------------------------------

def on_device(tree: dict, device) -> dict:
    """The arrays a walk reads of ``tree``, on ``device``."""
    return {k: torch.as_tensor(tree[k], device=device)
            for k in ("feature", "threshold", "children_left", "children_right")} | {
        "value": torch.as_tensor(tree["value"][:, 0, :], device=device),
        "max_depth": tree["max_depth"]}


def class_shares(trees_on, X, share_dtype=torch.float64) -> torch.Tensor:
    """(rows, F) float32 scaled rows -> (rows, K) class shares: each tree
    walked from its root to a leaf, the leaf fractions averaged in
    ``share_dtype``."""
    rows = torch.arange(len(X), device=X.device)
    out = torch.zeros((len(X), trees_on[0]["value"].shape[1]), dtype=share_dtype, device=X.device)
    for t in trees_on:
        node = torch.zeros(len(X), dtype=torch.int64, device=X.device)
        for _ in range(t["max_depth"]):
            f = t["feature"][node]
            go_left = X[rows, f.clamp(min=0)].double() <= t["threshold"][node]
            nxt = torch.where(go_left, t["children_left"][node], t["children_right"][node])
            node = torch.where(f >= 0, nxt, node)
        out += t["value"][node].to(share_dtype)
    return out / len(trees_on)


def _scores(trees_on, X, y_idx, share_dtype) -> torch.Tensor:
    """(c, n, F) copies of the test rows -> (c, 2) float64: each copy's
    accuracy and its rows' mean share of their true class (0 for a label
    never seen in training)."""
    c, n, F = X.shape
    shares = class_shares(trees_on, X.reshape(c * n, F), share_dtype).view(c, n, -1)
    acc = (torch.argmax(shares, dim=2) == y_idx).to(torch.float64).mean(1)
    true = shares[:, torch.arange(n, device=X.device), y_idx.clamp(min=0)].double()
    return torch.stack([acc, torch.where(y_idx >= 0, true, 0.0).mean(1)], 1)


def column_drops(trees_on, X, y_idx, *, n_repeats, seed, share_dtype):
    """Each column's mean accuracy drop ((F,) float64) and the drops of the
    rows' mean share of their true class ((F, n_repeats) float64) over
    ``n_repeats`` permutations of the test rows ``X`` ((n, F) float32
    scaled)."""
    n, F = X.shape
    gen = torch.Generator(device=X.device)
    gen.manual_seed(seed)
    perms = torch.argsort(torch.rand((F * n_repeats, n), generator=gen, dtype=torch.float64,
                                     device=X.device), dim=1)
    base = _scores(trees_on, X[None], y_idx, share_dtype)
    col = torch.arange(F, device=X.device).repeat_interleave(n_repeats)
    step = max(1, SCORE_ROWS // n)
    acc = []
    for s in range(0, F * n_repeats, step):
        p, c = perms[s:s + step], col[s:s + step]
        copies = X.expand(len(p), n, F).clone()
        draw = torch.arange(len(p), device=X.device)[:, None]
        copies[draw, torch.arange(n, device=X.device)[None], c[:, None]] = X[p, c[:, None]]
        acc.append(_scores(trees_on, copies, y_idx, share_dtype))
    drops = (base - torch.cat(acc)).view(F, n_repeats, 2)
    return drops[..., 0].mean(1), drops[..., 1]


def analyze(matrix, labels, train_idx, test_idx, *, head: dict, importance: dict, device,
            control=None) -> dict:
    """The forest of ``head`` (``n_estimators``, ``max_depth``, ``seed``)
    grown on the train rows of ``matrix`` ((n, F) float32 numpy, NaN already
    zeroed), MDI, the class shares of the test rows and the sweep of
    ``importance`` (``n_repeats``, ``seed``) on ``device``; ``control``:
    None or one of :data:`CONTROLS`. Returns the trees (sklearn's arrays),
    ``proba`` (n_test, K), ``mdi`` and ``column`` (F,) and ``share`` (F,
    n_repeats, the drops of the true class's mean share), numpy float64."""
    if control not in (None, *CONTROLS):
        raise ValueError(f"no control {control!r}")
    sums = torch.float32 if control == "f32" else torch.float64
    shares = torch.bfloat16 if control == "bf16_shares" else torch.float64
    X = torch.as_tensor(np.asarray(matrix, np.float32))
    labels = np.asarray(labels)
    classes, y_tr = np.unique(labels[train_idx], return_inverse=True)
    index = {c: i for i, c in enumerate(classes.tolist())}
    y_te = torch.as_tensor([index.get(v, -1) for v in labels[test_idx].tolist()], device=device)
    tr, te = torch.as_tensor(train_idx), torch.as_tensor(test_idx)
    lo, hi = X[tr].amin(0), X[tr].amax(0)
    span = hi - lo
    scale = torch.where(span != 0, 1.0 / torch.where(span != 0, span, 1.0), 1.0)
    with _no_tf32(), torch.no_grad():
        trees = grow_forest((X[tr] - lo) * scale, torch.as_tensor(y_tr), len(classes),
                            n_estimators=head["n_estimators"], max_depth=head["max_depth"],
                            seed=head["seed"], dtype=sums)
        trees_on = [on_device(t, device) for t in trees]
        Xte = ((X[te] - lo) * scale).to(device)
        proba = class_shares(trees_on, Xte, shares)
        column, share = column_drops(trees_on, Xte, y_te, n_repeats=importance["n_repeats"],
                                     seed=importance["seed"], share_dtype=shares)
    return {"trees": trees, "proba": proba.double().cpu().numpy(),
            "mdi": mdi(trees, X.shape[1], sums), "column": column.cpu().numpy(),
            "share": share.cpu().numpy()}
