"""Random-forest inference on the device (counterpart of
``tpumcia.models.forest_device``).

A fitted forest (the port's own :class:`~tpumcia_torch.models.forest_fit.Tree`
arrays, or sklearn's ``tree_`` objects) is laid out as dense tensors and
scored, on a CUDA device, by the hand-written walk kernel
(``csrc/forest_apply.cu``), and elsewhere in one of tpumcia's two forms,
chosen by the same rule (``_GEMM_MAX_CELLS``):

- *walk kernel*: each (draw, row) lane walks each tree from its root to a
  leaf over a compact layout of the forest (``_walk_arrays``), summing the
  leaf fractions in tree order; with row permutations and column masks
  (:meth:`DeviceForest.apply_permuted`) a draw reads its permuted columns
  in place, so the permutation sweep makes no permuted copy of the rows.
  ``_apply_walk`` is its plain version (``apply_permuted`` on the CPU,
  and what the tests hold the kernel against);
- *GEMM*: every internal node's comparison at once, then each sample's leaf
  per tree from one product with the (leaves x internal nodes) path matrix
  ``A`` in {-1, 0, +1}: leaf ``l`` is reached iff ``A_l . cmp`` equals its
  number of left branches. Trees go in blocks of ``_GEMM_TREE_BLOCK`` and
  samples in chunks, so no (trees, samples, leaves) tensor of the whole
  forest is made. The products are f32 with TF32 off: leaf fractions need
  the full f32 mantissa (tpumcia's ``Precision.HIGHEST``).
- *lock-step descent*: every (tree, sample) lane steps down one level per
  iteration for ``depth`` iterations, leaves looping to themselves.

Thresholds are the largest f32 at or below sklearn's f64 threshold, so
``x <= t32`` takes sklearn's branch for every f32 ``x``.
"""

from __future__ import annotations

import contextlib
import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from tpumcia_torch.models.forest_fit import Tree
from tpumcia_torch.models.scaler import MinMaxScaler
from tpumcia_torch.utils.device import require_device
from tpumcia_torch.utils.profiling import COUNTERS, trace

# the largest padded (leaves x internal nodes) per tree of the GEMM form;
# above it the dense path matrix costs more than the lock-step gathers
_GEMM_MAX_CELLS = 1 << 20
_GEMM_TREE_BLOCK = 8
# elements of the per-block (samples, trees, nodes) tensors scored at once
_GEMM_CHUNK_ELEMS = 1 << 26
# (tree, sample) lanes of the lock-step descent at once
_LOCKSTEP_LANES = 1 << 24


def _thr_f32_floor(thr_f64: np.ndarray) -> np.ndarray:
    """f64 split thresholds -> the largest f32 <= each threshold, so that
    ``x <= t32`` equals ``x <= thr_f64`` for every f32 ``x``."""
    t32 = np.asarray(thr_f64).astype(np.float32)
    up = t32.astype(np.float64) > np.asarray(thr_f64)
    return np.where(up, np.nextafter(t32, np.float32(-np.inf)), t32)


@contextlib.contextmanager
def _full_f32():
    """f32 products without TF32 for the duration."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _leaf_fractions(tree) -> np.ndarray:
    """(n, K) class fractions of a tree's nodes (sklearn >= 1.4 stores
    fractions already; the division keeps older count layouts right)."""
    vals = np.asarray(tree.value)[:, 0, :]
    sums = vals.sum(axis=1, keepdims=True)
    sums[sums == 0] = 1
    return vals / sums


def _apply_lockstep(X, feature, threshold, left, right, leaf_proba, depth):
    """X (S, F) -> (S, K) mean class probabilities by lock-step descent."""
    T = feature.shape[0]
    S = X.shape[0]
    out = []
    step = max(1, _LOCKSTEP_LANES // max(1, T))
    tr = torch.arange(T, device=X.device)[:, None]
    for s0 in range(0, S, step):
        x = X[s0:s0 + step]
        lanes = torch.arange(x.shape[0], device=X.device)[None, :]
        node = torch.zeros((T, x.shape[0]), dtype=torch.int64, device=X.device)
        for _ in range(depth):
            f = feature.gather(1, node)
            v = x[lanes, f.clamp(min=0)]
            nxt = torch.where(v <= threshold.gather(1, node), left.gather(1, node), right.gather(1, node))
            node = torch.where(f < 0, node, nxt)
        out.append(leaf_proba[tr, node].mean(0))
    return torch.cat(out)


def _apply_gemm(X, g_feature, g_threshold, A, target, g_leaf_proba):
    """X (S, F) -> (S, K) mean class probabilities by the GEMM form."""
    T, L, N = A.shape
    S = X.shape[0]
    K = g_leaf_proba.shape[-1]
    out = torch.zeros((S, K), dtype=torch.float32, device=X.device)
    step = max(1, _GEMM_CHUNK_ELEMS // (min(_GEMM_TREE_BLOCK, T) * max(L, N)))
    with _full_f32():
        for t0 in range(0, T, _GEMM_TREE_BLOCK):
            t1 = min(T, t0 + _GEMM_TREE_BLOCK)
            f, thr = g_feature[t0:t1], g_threshold[t0:t1]
            a, tgt, lp = A[t0:t1].to(torch.float32), target[t0:t1], g_leaf_proba[t0:t1]
            for s0 in range(0, S, step):
                x = X[s0:s0 + step]
                cmp = (x[:, f] <= thr[None]).to(torch.float32)  # (s, b, N)
                reached = torch.einsum("sbn,bln->bsl", cmp, a)
                hit = (reached.to(torch.int32) == tgt[:, None, :]).to(torch.float32)
                out[s0:s0 + step] += torch.einsum("bsl,blk->sk", hit, lp)
    return out / T


def _gemm_arrays(trees, K):
    """The padded GEMM-form arrays as numpy (tpumcia's ``_gemm_arrays``),
    or None when a tree's (leaves x internal nodes) exceeds
    ``_GEMM_MAX_CELLS``. Path rows come from walking each leaf up to the
    root."""
    per_tree = []
    max_n, max_l = 1, 1
    for tree in trees:
        f = np.asarray(tree.feature)
        internal, leaves = np.flatnonzero(f >= 0), np.flatnonzero(f < 0)
        max_n, max_l = max(max_n, len(internal)), max(max_l, len(leaves))
        per_tree.append((tree, internal, leaves))
    if max_n * max_l > _GEMM_MAX_CELLS:
        return None
    T = len(trees)
    g_feature = np.zeros((T, max_n), np.int32)
    g_threshold = np.full((T, max_n), -np.inf, np.float32)
    A = np.zeros((T, max_l, max_n), np.int8)
    target = np.full((T, max_l), -1, np.int32)  # pad rows never match
    g_leaf_proba = np.zeros((T, max_l, K), np.float32)
    for t, (tree, internal, leaves) in enumerate(per_tree):
        n = len(tree.feature)
        cl, cr = np.asarray(tree.children_left), np.asarray(tree.children_right)
        g_feature[t, :len(internal)] = np.asarray(tree.feature)[internal]
        g_threshold[t, :len(internal)] = _thr_f32_floor(np.asarray(tree.threshold)[internal])
        g_leaf_proba[t, :len(leaves)] = _leaf_fractions(tree)[leaves].astype(np.float32)
        int_idx = np.full(n, -1, np.int64)
        int_idx[internal] = np.arange(len(internal))
        parent = np.full(n, -1, np.int64)
        parent[cl[internal]] = internal
        parent[cr[internal]] = internal
        li = np.arange(len(leaves))
        node = leaves.copy()
        n_left = np.zeros(len(leaves), np.int32)
        up = parent[node]
        while (up >= 0).any():
            on = up >= 0
            p = up[on]
            went_left = cl[p] == node[on]
            A[t, li[on], int_idx[p]] = np.where(went_left, 1, -1)
            n_left[on] += went_left
            node[on] = p
            up = np.where(on, parent[node], -1)
        target[t, :len(leaves)] = n_left  # A . cmp == #left branches on the path
    return g_feature, g_threshold, A, target, g_leaf_proba


def _walk_arrays(trees):
    """The walk kernel's compact layout as numpy: ``nodes`` (M, 4) int32,
    the trees' nodes one after another, each [feature (-1 at a leaf), the
    f32 threshold's bits, the left and right children's indices in
    ``nodes``], a leaf's third entry its row of ``values``; ``roots`` (T,)
    int32; ``values`` (U, K) f32, the distinct rows of leaf fractions (K
    rows where every leaf is pure); the number of features the splits read.
    Children must come after their parent (sklearn's and the grower's
    order), so every walk ends."""
    counts = [len(t.feature) for t in trees]
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    nodes = np.zeros((offsets[-1], 4), np.int32)
    leaf_rows = []
    for t, tree in enumerate(trees):
        lo, hi = offsets[t], offsets[t + 1]
        f = np.asarray(tree.feature, np.int64)
        leaf = f < 0
        cl, cr = np.asarray(tree.children_left, np.int64), np.asarray(tree.children_right, np.int64)
        idx = np.arange(hi - lo)
        inner = ~leaf
        if ((np.minimum(cl, cr)[inner] <= idx[inner]) | (np.maximum(cl, cr)[inner] >= hi - lo)).any():
            raise ValueError(f"tree {t}: a child index is not after its parent's or past the tree")
        thr = _thr_f32_floor(np.asarray(tree.threshold)).astype(np.float32).view(np.int32)
        nodes[lo:hi, 0] = np.where(leaf, -1, f)
        nodes[lo:hi, 1] = np.where(leaf, 0, thr)
        nodes[lo:hi, 2] = np.where(leaf, 0, cl + lo)
        nodes[lo:hi, 3] = np.where(leaf, 0, cr + lo)
        leaf_rows.append(_leaf_fractions(tree)[leaf].astype(np.float32))
    values, row = np.unique(np.concatenate(leaf_rows), axis=0, return_inverse=True)
    nodes[nodes[:, 0] < 0, 2] = row.reshape(-1)
    n_features = int(nodes[:, 0].max()) + 1
    return nodes, offsets[:-1].astype(np.int32), np.ascontiguousarray(values, np.float32), n_features


def _apply_walk(X, nodes, roots, values, perms=None, masks=None, repeats=1):
    """The walk kernel's plain version: X (N, F) scaled f32 rows -> (D, N, K)
    mean class shares (D = 1 without ``perms``). With ``perms`` (D, N) and
    ``masks`` (G, F), draw d reads feature f of row n from row
    ``perms[d, n]`` where ``masks[d // repeats, f]`` is nonzero, else from
    row n. Each (draw, row) lane walks each tree from its root to a leaf
    (left iff ``x <= threshold``, so NaN goes right); the trees' leaf
    fractions are summed in tree order in f32, then divided by T."""
    N, F = X.shape
    rows = torch.arange(N, device=X.device)
    if perms is None:
        src, permuted = rows[None], torch.zeros((1, F), dtype=torch.bool, device=X.device)
    else:
        src = perms
        permuted = masks.to(torch.bool)[torch.arange(perms.shape[0], device=X.device) // repeats]
    feature, left, right = nodes[:, 0].long(), nodes[:, 2].long(), nodes[:, 3].long()
    threshold = nodes[:, 1].view(torch.float32)
    out = torch.zeros((src.shape[0], N, values.shape[1]), dtype=torch.float32, device=X.device)
    for root in roots.tolist():
        node = torch.full((src.shape[0], N), root, dtype=torch.long, device=X.device)
        f = feature[node]
        while bool((f >= 0).any()):
            fc = f.clamp(min=0)
            x = X[torch.where(permuted.gather(1, fc), src, rows), fc]
            node = torch.where(f >= 0, torch.where(x <= threshold[node], left[node], right[node]), node)
            f = feature[node]
        out += values[left[node]]
    return out / len(roots)


def _launch_walk(X, perms, masks, repeats, nodes, roots, values, n_features):
    """The walk kernel on the card: the arguments and result of
    :func:`_apply_walk`, ``masks`` as (G, F) uint8. Adds the lanes it scored
    to ``COUNTERS["forest_kernel_lanes"]`` and its launch to
    ``COUNTERS["forest_kernel_launches"]``."""
    from tpumcia_torch import _build

    dev = nodes.device
    if dev.type != "cuda":
        raise ValueError(f"the forest walk kernel runs on a CUDA device; the forest is on {dev}")
    if (X.device != dev or X.dtype != torch.float32 or X.dim() != 2 or not X.is_contiguous()
            or X.shape[1] < n_features):
        raise ValueError(
            f"the forest walk kernel wants contiguous (N, F >= {n_features}) float32 rows on {dev}; "
            f"got {X.dtype} shape {tuple(X.shape)} on {X.device}")
    N, F = X.shape
    D = 1 if perms is None else perms.shape[0]
    if perms is not None and (
        perms.device != dev or perms.dtype != torch.int64 or tuple(perms.shape) != (D, N)
        or not perms.is_contiguous() or masks.device != dev or masks.dtype != torch.uint8
        or masks.dim() != 2 or masks.shape[1] != F or not masks.is_contiguous()
        or repeats < 1 or masks.shape[0] * repeats < D
    ):
        raise ValueError(
            "the forest walk kernel wants contiguous (D, N) int64 permutations and (G, F) uint8 "
            f"masks with G * repeats >= D on {dev}; got {perms.dtype} {tuple(perms.shape)}, "
            f"{masks.dtype} {tuple(masks.shape)}, repeats {repeats} for rows {tuple(X.shape)}")
    K = values.shape[1]
    out = torch.empty((D, N, K), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = _build.load_library().tpumcia_forest_apply(
            X.data_ptr(), N, F, None if perms is None else perms.data_ptr(),
            None if perms is None else masks.data_ptr(), repeats, D,
            nodes.data_ptr(), nodes.shape[0], roots.data_ptr(), roots.shape[0],
            values.data_ptr(), values.shape[0], K, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(code, "forest_apply kernel launch")
    COUNTERS["forest_kernel_lanes"] += roots.shape[0] * D * N
    COUNTERS["forest_kernel_launches"] += 1
    return out


@dataclass
class DeviceForest:
    feature: torch.Tensor  # (T, N) int64, -1 at leaves
    threshold: torch.Tensor  # (T, N) f32
    left: torch.Tensor  # (T, N) int64 (self at leaves)
    right: torch.Tensor  # (T, N) int64
    leaf_proba: torch.Tensor  # (T, N, K) f32
    depth: int
    classes: np.ndarray
    scaler: MinMaxScaler | None = None
    # GEMM-form tensors (None for forests too large for the dense path matrix)
    gemm: tuple | None = None
    # the walk kernel's layout (``_walk_arrays``: nodes, roots, values as
    # tensors, the number of features the splits read)
    walk: tuple | None = None

    @classmethod
    @trace("forest_layout")
    def from_arrays(cls, trees, classes, scaler: MinMaxScaler | None = None, *,
                    device="cuda") -> "DeviceForest":
        """Lay out fitted trees (:class:`Tree` or sklearn ``tree_`` objects,
        read by duck typing) on ``device``, in one ``forest_layout`` span."""
        require_device(device, "DeviceForest.from_arrays")
        T = len(trees)
        N = max(len(t.feature) for t in trees)
        K = np.asarray(trees[0].value).shape[-1]
        feature = np.full((T, N), -1, np.int64)
        threshold = np.zeros((T, N), np.float32)
        left = np.zeros((T, N), np.int64)
        right = np.zeros((T, N), np.int64)
        proba = np.zeros((T, N, K), np.float32)
        depth = 0
        for t, tree in enumerate(trees):
            n = len(tree.feature)
            f = np.asarray(tree.feature, np.int64)
            leaf = f < 0
            idx = np.arange(n)
            feature[t, :n] = np.where(leaf, -1, f)
            threshold[t, :n] = _thr_f32_floor(np.asarray(tree.threshold))
            left[t, :n] = np.where(leaf, idx, np.asarray(tree.children_left))
            right[t, :n] = np.where(leaf, idx, np.asarray(tree.children_right))
            proba[t, :n] = _leaf_fractions(tree).astype(np.float32)
            depth = max(depth, int(tree.max_depth))
        *walk, n_features = _walk_arrays(trees)  # first: it refuses a tree whose walk would not end
        gemm = _gemm_arrays(trees, K)

        def dev(a):
            return torch.from_numpy(a).to(device)

        return cls(
            feature=dev(feature), threshold=dev(threshold), left=dev(left), right=dev(right),
            leaf_proba=dev(proba), depth=depth, classes=np.asarray(classes), scaler=scaler,
            gemm=None if gemm is None else tuple(dev(a) for a in gemm),
            walk=(*(dev(a) for a in walk), n_features),
        )

    @classmethod
    def from_sklearn(cls, model, classes=None, scaler: MinMaxScaler | None = None, *,
                     device="cuda") -> "DeviceForest":
        """A fitted sklearn ``RandomForestClassifier`` (``model.estimators_``
        and their ``tree_``, read by duck typing; sklearn is not imported)."""
        trees = [Tree.from_tree_(est.tree_) for est in model.estimators_]
        return cls.from_arrays(trees, model.classes_ if classes is None else classes, scaler,
                               device=device)

    @property
    def device(self) -> torch.device:
        return self.feature.device

    @property
    def form(self) -> str:
        """The inference form that runs: ``'kernel'`` (the walk kernel) on a
        CUDA device, else ``'gemm'`` or ``'lockstep'``."""
        if self.device.type == "cuda":
            return "kernel"
        return "lockstep" if self.gemm is None else "gemm"

    def apply_fn(self):
        """tpumcia's scoring callable: ``f(X_scaled)``, (..., F) scaled f32
        features on the forest's device -> (..., K) mean class
        probabilities (:meth:`apply`)."""
        return self.apply

    @trace("forest_apply")
    def apply(self, X: torch.Tensor, *, form: str | None = None) -> torch.Tensor:
        """(..., F) scaled f32 features -> (..., K) mean class probabilities,
        by the forest's form (or ``form``): one ``forest_apply`` span, its
        (tree, row) pairs added to ``COUNTERS["forest_lanes"]``."""
        lead = X.shape[:-1]
        x = X.reshape(-1, X.shape[-1])
        COUNTERS["forest_lanes"] += self.feature.shape[0] * x.shape[0]
        form = form or self.form
        if form == "kernel":
            p = _launch_walk(x.contiguous(), None, None, 1, *self.walk)[0]
        elif form == "gemm":
            p = _apply_gemm(x, *self.gemm)
        else:
            p = _apply_lockstep(x, self.feature, self.threshold, self.left, self.right,
                                self.leaf_proba, self.depth)
        return p.reshape(*lead, p.shape[-1])

    @trace("forest_apply")
    def apply_permuted(self, X: torch.Tensor, perms: torch.Tensor, masks: torch.Tensor,
                       repeats: int) -> torch.Tensor:
        """(N, F) scaled f32 rows under D draws -> (D, N, K) mean class
        probabilities. Draw d reads the columns that ``masks[d // repeats]``
        ((G, F), nonzero) marks from rows ``perms[d]`` ((D, N) int64) and
        the others from its own rows: the rows ``torch.where(permuted,
        X[perms], X)`` would hold, without the copy. Every entry of
        ``perms`` must be a row of X, as
        :func:`~tpumcia_torch.importance.permutation.draw_permutations`
        draws them: the kernel reads them unchecked. The walk kernel on a
        forest of form ``'kernel'``, else its plain version; one
        ``forest_apply`` span, its (tree, draw, row) lanes added to
        ``COUNTERS["forest_lanes"]``."""
        COUNTERS["forest_lanes"] += self.feature.shape[0] * perms.numel()
        if self.form == "kernel":
            return _launch_walk(X.contiguous(), perms.contiguous(),
                                (masks != 0).to(torch.uint8).contiguous(), repeats, *self.walk)
        return _apply_walk(X, *self.walk[:3], perms, masks, repeats)

    def kernel_launch_info(self, lanes: int) -> dict:
        """How the walk kernel would launch over ``lanes`` (draw, row) lanes
        of this CUDA forest: threads a block, dynamic shared memory bytes (0
        where the forest is read from device memory), resident blocks per SM,
        whether the forest sits in shared memory, and the grid."""
        from tpumcia_torch import _build

        nodes, roots, values, _ = self.walk
        info = (ctypes.c_int * 5)()
        with torch.cuda.device(self.device):
            _build.check(_build.load_library().tpumcia_forest_launch_info(
                nodes.shape[0], values.shape[0], values.shape[1], roots.shape[0], lanes, info),
                "forest_apply launch info")
        return {"threads": info[0], "smem_bytes": info[1], "blocks_per_sm": info[2],
                "forest_in_smem": bool(info[3]), "grid": info[4]}

    def _prep(self, X) -> torch.Tensor:
        X = torch.as_tensor(X, dtype=torch.float32, device=self.device)
        return self.scaler.transform(X) if self.scaler is not None else X

    @torch.no_grad()
    def predict_proba(self, X) -> torch.Tensor:
        return self.apply(self._prep(X))

    def predict(self, X) -> np.ndarray:
        return self.classes[torch.argmax(self.predict_proba(X), dim=-1).cpu().numpy()]

    def score(self, X, y) -> float:
        return float(np.mean(self.predict(X) == np.asarray(y)))
