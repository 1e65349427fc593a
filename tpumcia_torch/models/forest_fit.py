"""The port's own random-forest fit: the counterpart of sklearn's
``RandomForestClassifier(n_estimators, max_depth, random_state=seed)`` as
``tpumcia.models.heads.RandomForestHead.fit`` configures it (every other
argument at sklearn's default), grown on the device it is given.

The semantics are sklearn's, and the tests hold the grower to sklearn's own
trees:

- *bootstrap*: each tree draws n row indices uniformly with replacement;
  their counts are the rows' sample weights, and rows of weight 0 take no
  part in the tree;
- *criterion*: Gini on weighted class counts, ``max_features='sqrt'``
  (``max(1, int(sqrt(F)))``), ``min_samples_split=2``,
  ``min_samples_leaf=1``. A node is a leaf when it is pure (impurity <=
  float64 eps), has fewer than 2 rows, is at ``max_depth`` or has no valid
  split;
- *features at a node*: visited in a random order, stopping after
  ``max_features`` visits unless every feature visited so far was constant in
  the node (``x_max <= x_min + 1e-7`` in float32, sklearn's
  ``FEATURE_THRESHOLD``), then going on to the first that is not;
- *split positions*: a boundary between neighbouring sorted values is valid
  where ``x[p] > x[p-1] + 1e-7`` (float32); the threshold is
  ``x[p-1]/2 + x[p]/2`` in float64 (``x[p-1]`` where that sum is ``x[p]`` or
  infinite);
- *best split*: the largest Gini proxy ``-w_r*imp_r - w_l*imp_l``, computed
  as sklearn computes it, ties to the first in visit order, then in position;
- *per node*: sklearn's ``tree_`` arrays (:class:`Tree`), nodes numbered in
  sklearn's depth-first order.

Design: every column is sorted once. A chunk of trees grows level by level
with a node id per (tree, row), holding per (tree, feature) the rows still
in a growing node, grouped by node and in feature order within a node: class
by class a cumulative sum of the weights gives the left and right counts at
every boundary, and a segmented max picks each node's split. After a level,
a stable sort by the rows' new node ids regroups them and cuts off the rows
that reached a leaf, so each level costs what its active rows cost. The weights are
bootstrap counts, so every sum is an exact integer in float64 in any order,
and the card and the CPU pick the same split bit for bit. The host waits on
the device once a level, for the level's records, and draws each level's
feature orders while the device works on what needs none.

Randomness comes from CPU ``torch.Generator`` s seeded per tree with
``synth_batch_seed(seed, tree)``: first the tree's bootstrap, then a feature
order per node, level by level. A seed gives the same forest on any device
and at any chunk size; sklearn's own streams are not reproduced.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from tpumcia_torch.preprocess.synth import synth_batch_seed
from tpumcia_torch.utils.profiling import COUNTERS, trace

FEATURE_THRESHOLD = 1e-7  # sklearn's tie tolerance, a float32 constant there
EPSILON = float(np.finfo(np.float64).eps)
TREE_LEAF = -1
TREE_UNDEFINED = -2
# (trees x features x rows) elements grown at once; a level holds about 25
# such tensors of up to 8 bytes (1 << 25 elements: about 7 GB)
CHUNK_ELEMS = 1 << 25


@dataclass
class Tree:
    """One fitted tree in the layout of sklearn's ``tree_`` (so either
    package's trees feed the same inference and MDI code)."""

    children_left: np.ndarray  # (n,) int64, -1 at leaves
    children_right: np.ndarray  # (n,) int64, -1 at leaves
    feature: np.ndarray  # (n,) int64, -2 at leaves
    threshold: np.ndarray  # (n,) float64, -2 at leaves
    value: np.ndarray  # (n, 1, K) float64 weighted class fractions
    impurity: np.ndarray  # (n,) float64 Gini
    n_node_samples: np.ndarray  # (n,) int64 rows
    weighted_n_node_samples: np.ndarray  # (n,) float64
    max_depth: int

    @property
    def node_count(self) -> int:
        return len(self.feature)

    @classmethod
    def from_tree_(cls, t) -> "Tree":
        """Copy a fitted sklearn ``tree_`` (read by duck typing)."""
        return cls(
            children_left=np.asarray(t.children_left, np.int64),
            children_right=np.asarray(t.children_right, np.int64),
            feature=np.asarray(t.feature, np.int64),
            threshold=np.asarray(t.threshold, np.float64),
            value=np.asarray(t.value, np.float64),
            impurity=np.asarray(t.impurity, np.float64),
            n_node_samples=np.asarray(t.n_node_samples, np.int64),
            weighted_n_node_samples=np.asarray(t.weighted_n_node_samples, np.float64),
            max_depth=int(t.max_depth),
        )


def max_features_sqrt(num_features: int) -> int:
    """sklearn's ``max_features='sqrt'``."""
    return max(1, int(np.sqrt(num_features)))


class RandomOrders:
    """Each node's feature visit order: a uniform permutation per node, drawn
    from its tree's generator as ``argsort`` of float64 uniforms."""

    def __init__(self, generators: list[torch.Generator], num_features: int):
        self.generators = generators
        self.num_features = num_features

    def __call__(self, tree: int, depth: int, n: int) -> torch.Tensor:
        u = torch.rand((n, self.num_features), generator=self.generators[tree], dtype=torch.float64)
        return torch.argsort(u, dim=1, stable=True)


def fit_forest(
    X: torch.Tensor, y_idx: torch.Tensor, num_classes: int, *,
    n_estimators: int, max_depth: int | None, seed: int,
) -> list[Tree]:
    """Fit ``n_estimators`` trees on ``X`` ((N, F) f32, on the device the
    fit runs on) and class indices ``y_idx`` ((N,) int64 in [0,
    num_classes), on any device), with bootstraps and feature orders from
    ``seed``."""
    n, f = X.shape
    gens = [torch.Generator().manual_seed(synth_batch_seed(seed, t)) for t in range(n_estimators)]
    counts = torch.stack([
        torch.bincount(torch.randint(0, n, (n,), generator=g), minlength=n) for g in gens
    ])
    return grow_trees(
        X, y_idx, num_classes, counts.to(torch.float64),
        max_depth=max_depth, max_features=max_features_sqrt(f),
        feature_orders=RandomOrders(gens, f),
    )


def grow_trees(
    X: torch.Tensor, y_idx: torch.Tensor, num_classes: int, weights: torch.Tensor, *,
    max_depth: int | None, max_features: int, feature_orders, chunk_elems: int = CHUNK_ELEMS,
) -> list[Tree]:
    """One tree per row of ``weights`` ((T, N) float64 integer sample
    weights on the host). ``feature_orders(tree, depth, n)`` gives the
    (n, F) int64 visit orders of a tree's n nodes at ``depth``, left to
    right, and is called for every tree at every level it reaches, in tree
    order. A chunk's trees are assembled while the next chunk's first level
    runs on the device."""
    n, f = X.shape
    if n == 0 or f == 0:
        raise ValueError(f"cannot grow trees on a {tuple(X.shape)} matrix")
    X = X.to(torch.float32).contiguous()
    si = torch.argsort(X.t(), dim=1, stable=True)  # (F, N) each column's rows in order
    per = max(1, chunk_elems // (f * n))
    depth_cap = np.iinfo(np.int32).max if max_depth is None else int(max_depth)
    y_idx = _to_device(y_idx.to(torch.int64), X.device)
    bootstrap_rows = (weights > 0).sum(1).numpy()  # each tree's rows of weight > 0
    weights = _to_device(weights, X.device)
    trees: list[Tree] = []
    grown = []  # the last chunk's (levels, trees), not yet assembled

    def assemble_grown():
        while grown:
            levels, num_trees = grown.pop()
            trees.extend(_assemble(levels, num_trees=num_trees, num_classes=num_classes))

    for t0 in range(0, weights.shape[0], per):
        levels = _grow_chunk(
            X, si, y_idx, num_classes, weights[t0:t0 + per], first_tree=t0,
            rows_in=int(bootstrap_rows[t0:t0 + per].max()), max_depth=depth_cap,
            max_features=min(max_features, f), feature_orders=feature_orders, while_queued=assemble_grown,
        )
        grown.append((levels, min(per, weights.shape[0] - t0)))
    assemble_grown()
    return trees


def _grow_chunk(X, si, y, K, w, *, first_tree, rows_in, max_depth, max_features, feature_orders,
                while_queued):
    """Grow a chunk of trees level by level; returns each level's node
    records on the host (numpy), nodes ordered by tree, then left to right.
    ``si``: the rows of each column of X in sorted order; ``rows_in``: the
    most rows of weight > 0 a tree of the chunk has.

    The host waits on the device once a level, for the level's records, and
    derives from them all the next level needs on the host: its node count,
    each node's tree and the most rows a tree keeps growing. A level queues
    its device work that needs no feature order first, and draws the orders
    while the device works through it; ``while_queued()`` (the caller's
    host work) runs before the wait. Each level is one ``forest_level``
    span and adds 1 to ``COUNTERS["forest_levels"]`` and
    ``COUNTERS["forest_fit_waits"]``, and its nodes to
    ``COUNTERS["forest_nodes"]``."""
    dev = X.device
    Tc, N = w.shape
    F = X.shape[1]
    f64 = torch.float64
    thr32 = torch.full((), FEATURE_THRESHOLD, dtype=torch.float32, device=dev)
    rows = torch.arange(N, device=dev)
    fidx = torch.arange(F, device=dev)
    ones_i64 = torch.ones((), dtype=torch.int64, device=dev).expand(Tc * N)
    XT = X.t().contiguous()  # (F, N)
    total_w = w.sum(1)  # the tree's weighted_n_samples
    tree_host = np.arange(Tc)  # each node's tree, on the host
    S = Tc  # nodes at this level; S is also the sentinel id of inactive rows
    nid = torch.where(w > 0, torch.arange(Tc, device=dev)[:, None], S)
    row_s, M = si.expand(Tc, F, N), min(N, max(2, rows_in))

    def grow_level(S, depth, M, nid, row_s, tree_host):
        """Queue one level, wait for its records; returns the next level's
        ``nid`` and this level's records (its tensors die on return)."""
        tree_of = _to_device(torch.from_numpy(tree_host), dev)

        # per node: rows, class totals, weight, impurity (node_impurity)
        cnt = torch.zeros(S + 1, dtype=torch.int64, device=dev).index_add_(0, nid.flatten(), ones_i64)[:S]
        tot = torch.zeros((S + 1) * K, dtype=f64, device=dev)
        tot.index_add_(0, (nid * K + y[None, :]).flatten(), w.flatten())
        tot = tot.view(S + 1, K)[:S]
        W = tot.sum(1)
        sq = torch.zeros(S, dtype=f64, device=dev)
        for k in range(K):
            sq = sq + tot[:, k] * tot[:, k]
        imp = 1.0 - sq / (W * W)
        leaf = (depth >= max_depth) | (cnt < 2) | (imp <= EPSILON)

        # each node's segment [start, start + cnt) in its tree's rows
        excl = torch.cumsum(cnt, 0) - cnt
        first = torch.searchsorted(tree_of, tree_of)
        start = excl - excl[first]

        node_s = torch.gather(nid[:, None, :].expand(Tc, F, N), 2, row_s)
        x_s = torch.gather(XT[None].expand(Tc, F, N), 2, row_s)
        w_s = torch.gather(w[:, None, :].expand(Tc, F, N), 2, row_s)
        y_s = y[row_s]
        valid = torch.zeros_like(node_s, dtype=torch.bool)
        valid[..., 1:] = ((node_s[..., 1:] == node_s[..., :-1]) & (node_s[..., 1:] < S)
                          & (x_s[..., 1:] > x_s[..., :-1] + thr32))
        pad = torch.zeros(1, dtype=torch.int64, device=dev)
        start_pos = torch.cat([start, pad])[node_s]  # each position's segment start

        # left and right class counts at every boundary, class by class
        sq_l = torch.zeros(node_s.shape, dtype=f64, device=dev)
        sq_r = torch.zeros_like(sq_l)
        w_l = torch.zeros_like(sq_l)
        tot_pad = torch.cat([tot, torch.zeros((1, K), dtype=f64, device=dev)])
        for k in range(K):
            wk = torch.where(y_s == k, w_s, 0.0)
            before = torch.cumsum(wk, 2) - wk
            lk = before - torch.gather(before, 2, start_pos)
            rk = tot_pad[:, k][node_s] - lk
            sq_l += lk * lk
            sq_r += rk * rk
            w_l += lk
            del wk, before, lk, rk
        w_r = torch.cat([W, W.new_zeros(1)])[node_s] - w_l
        one = torch.ones((), dtype=f64, device=dev)
        wl_safe, wr_safe = torch.where(valid, w_l, one), torch.where(valid, w_r, one)
        imp_l = 1.0 - sq_l / (wl_safe * wl_safe)
        imp_r = 1.0 - sq_r / (wr_safe * wr_safe)
        proxy = torch.where(valid, -w_r * imp_r - w_l * imp_l, -math.inf)

        # each (node, feature)'s best proxy and its first position
        seg = (node_s * F + fidx[None, :, None]).flatten()
        best = torch.full(((S + 1) * F,), -math.inf, dtype=f64, device=dev)
        best.scatter_reduce_(0, seg, proxy.flatten(), "amax")
        pos = torch.arange(M, device=dev).expand(node_s.shape)
        hit = valid & (proxy == best[seg].view(node_s.shape))
        first_pos = torch.full(((S + 1) * F,), M, dtype=torch.int64, device=dev)
        first_pos.scatter_reduce_(0, seg, torch.where(hit, pos, M).flatten(), "amin")
        best, first_pos = best[:S * F].view(S, F), first_pos[:S * F].view(S, F)
        x_min = x_s[tree_of[:, None], fidx[None, :], start[:, None]]
        x_max = x_s[tree_of[:, None], fidx[None, :], (start + cnt - 1)[:, None]]

        # the features each node visits, in its order: drawn on the host
        # while the device works through the above
        counts = _tree_sums(tree_host, 1, Tc)
        orders = _to_device(_level_orders(feature_orders, first_tree, counts, depth, F), dev)
        nonconst = x_max > x_min + thr32
        rank = torch.empty_like(orders).scatter_(1, orders, fidx.expand(S, F).contiguous())
        first_nc = torch.where(nonconst, rank, F).amin(1)
        visits = torch.clamp(torch.maximum(torch.full_like(first_nc, max_features), first_nc + 1), max=F)
        cand = nonconst & (rank < visits[:, None])
        score = torch.where(cand, best, -math.inf)
        top = score.amax(1)
        tie = cand & (score == top[:, None])
        fstar = torch.where(tie, rank, F).argmin(1)
        has_split = top > -math.inf
        pstar = first_pos[torch.arange(S, device=dev), fstar].clamp(1, M - 1)
        a = x_s[tree_of, fstar, pstar - 1].to(f64)
        b = x_s[tree_of, fstar, pstar].to(f64)
        thr = a / 2.0 + b / 2.0
        thr = torch.where((thr == b) | torch.isinf(thr), a, thr)
        # sklearn's impurity_improvement at the chosen split
        at = (tree_of, fstar, pstar)
        wl_c, wr_c = w_l[at], w_r[at]
        il = 1.0 - sq_l[at] / (wl_c * wl_c)
        ir = 1.0 - sq_r[at] / (wr_c * wr_c)
        improvement = (W / total_w[tree_of]) * (imp - (wr_c / W * ir) - (wl_c / W * il))
        del node_s, x_s, w_s, y_s, valid, start_pos, sq_l, sq_r, w_l, w_r, proxy, hit, pos, seg
        leaf = leaf | ~has_split | (improvement + EPSILON < 0.0)
        split = ~leaf

        # the children of the j-th splitting node are nodes 2j, 2j+1 next
        # level; rows in no growing node take its node count, the sentinel
        j = torch.cumsum(split.to(torch.int64), 0) - 1
        active = nid < S
        node = torch.where(active, nid, 0)
        xv = X[rows[None, :], fstar[node]]
        go_right = ~(xv.to(f64) <= thr[node])
        nid = torch.where(active & split[node], 2 * j[node] + go_right, 2 * split.sum())

        record = _read_back(dict(leaf=leaf, feature=fstar, threshold=thr, impurity=imp, n=cnt,
                                 weight=W, totals=tot), dev, while_queued)
        record["tree"] = tree_host
        return nid, record

    levels, depth = [], 0
    while S:
        with trace("forest_level"):
            # the active rows of every (tree, feature), grouped by node, each
            # node's in feature order; M = the most active rows of a tree
            row_s = _regroup(nid, row_s, M)
            nid, record = grow_level(S, depth, M, nid, row_s, tree_host)
        levels.append(record)
        COUNTERS["forest_levels"] += 1
        COUNTERS["forest_nodes"] += S
        grows = ~record["leaf"]
        # every row of a splitting node moves to one of its children
        rows_on = _tree_sums(tree_host[grows], record["n"][grows], Tc)
        S, depth, M = 2 * int(grows.sum()), depth + 1, min(M, max(2, int(rows_on.max())))
        tree_host = np.repeat(tree_host[grows], 2)
    return levels


def _tree_sums(tree: np.ndarray, values, num_trees: int) -> np.ndarray:
    """Per tree of a chunk, the sum of ``values`` over its nodes (``tree``:
    each node's tree; host arrays, int64)."""
    sums = np.zeros(num_trees, np.int64)
    np.add.at(sums, tree, values)
    return sums


def _to_device(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``t`` on ``dev``: a host tensor goes to a CUDA device from pinned
    memory, without waiting for the device."""
    if dev.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def _read_back(tensors: dict, dev: torch.device, while_queued) -> dict:
    """A level's records as numpy arrays, after the fit's one wait of the
    level (``COUNTERS["forest_fit_waits"]``, counted on every device): on a
    CUDA device copied into pinned host memory without blocking, then
    ``while_queued()`` run, then a wait on an event behind the copies."""
    COUNTERS["forest_fit_waits"] += 1
    if dev.type != "cuda":
        while_queued()
        return {k: v.numpy() for k, v in tensors.items()}
    host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True).copy_(v, non_blocking=True)
            for k, v in tensors.items()}
    copied = torch.cuda.Event()
    copied.record(torch.cuda.current_stream(dev))
    while_queued()
    copied.synchronize()
    return {k: v.numpy() for k, v in host.items()}


def _regroup(nid, row_s, M) -> torch.Tensor:
    """(Tc, F, ·) rows of each (tree, feature), in feature order within each
    node of the previous grouping -> the same sorted stably by their node id
    ``nid`` (so still in feature order within a node) and cut to (Tc, F,
    M): ``M`` is the most rows a tree has in growing nodes (at least 2 where
    the chunk has 2 rows, so a split position and the one before it index
    into it), and the rows in no growing node hold the sentinel, sorting
    last."""
    key = torch.gather(nid[:, None, :].expand(-1, row_s.shape[1], -1), 2, row_s)
    order = torch.argsort(key, dim=2, stable=True)
    return torch.gather(row_s, 2, order[..., :M])


def _level_orders(feature_orders, first_tree, counts, depth, F) -> torch.Tensor:
    """The (S, F) visit orders of one level's nodes (tree-ordered), on the
    host; ``counts``: each tree's nodes at this level (a host array)."""
    parts = [
        feature_orders(first_tree + t, depth, int(c)).to(torch.int64).reshape(int(c), F)
        for t, c in enumerate(counts) if c
    ]
    return torch.cat(parts)


def _assemble(levels, *, num_trees: int, num_classes: int) -> list[Tree]:
    """Level records -> one :class:`Tree` per tree, nodes renumbered into
    sklearn's depth-first order (a node, its left subtree, its right)."""
    # subtree sizes, bottom up; a splitting node's children are 2j, 2j+1
    sizes = [None] * len(levels)
    for d in range(len(levels) - 1, -1, -1):
        lv = levels[d]
        size = np.ones(len(lv["leaf"]), np.int64)
        split = ~lv["leaf"]
        if split.any():
            child = sizes[d + 1]
            size[split] += child[0::2] + child[1::2]
        sizes[d] = size
    # preorder ids, top down: left child p + 1, right p + 1 + size(left)
    pre = [levels[0]["tree"] * 0]
    for d in range(len(levels) - 1):
        split = ~levels[d]["leaf"]
        p = pre[d][split]
        nxt = np.empty(2 * len(p), np.int64)
        nxt[0::2] = p + 1
        nxt[1::2] = p + 1 + sizes[d + 1][0::2]
        pre.append(nxt)
    node_count = np.zeros(num_trees, np.int64)
    node_count[levels[0]["tree"]] = sizes[0]
    max_depth = np.zeros(num_trees, np.int64)
    cols = {k: [] for k in ("tree", "pre", "leaf", "feature", "threshold", "impurity", "n",
                            "weight", "totals", "left", "right")}
    for d, lv in enumerate(levels):
        np.maximum.at(max_depth, lv["tree"], d)
        split = ~lv["leaf"]
        left = np.full(len(split), TREE_LEAF, np.int64)
        right = left.copy()
        if split.any():
            left[split], right[split] = pre[d + 1][0::2], pre[d + 1][1::2]
        for k, v in (("pre", pre[d]), ("left", left), ("right", right)):
            cols[k].append(v)
        for k in ("tree", "leaf", "feature", "threshold", "impurity", "n", "weight", "totals"):
            cols[k].append(lv[k])
    c = {k: np.concatenate(v) for k, v in cols.items()}
    order = np.lexsort((c["pre"], c["tree"]))  # by tree, then depth-first
    c = {k: v[order] for k, v in c.items()}
    leaf = c["leaf"]
    bounds = np.cumsum(node_count)[:-1]

    def per_tree(a):
        return np.split(a, bounds)

    fields = dict(
        children_left=per_tree(c["left"]),
        children_right=per_tree(c["right"]),
        feature=per_tree(np.where(leaf, TREE_UNDEFINED, c["feature"]).astype(np.int64)),
        threshold=per_tree(np.where(leaf, float(TREE_UNDEFINED), c["threshold"])),
        value=per_tree((c["totals"] / c["weight"][:, None])[:, None, :]),
        impurity=per_tree(c["impurity"]),
        n_node_samples=per_tree(c["n"].astype(np.int64)),
        weighted_n_node_samples=per_tree(c["weight"]),
    )
    return [
        Tree(**{k: v[t] for k, v in fields.items()}, max_depth=int(max_depth[t]))
        for t in range(num_trees)
    ]
