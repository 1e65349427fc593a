"""Random-forest inference on the device (counterpart of
``tpumcia.models.forest_device``).

A fitted forest (the port's own :class:`~tpumcia_torch.models.forest_fit.Tree`
arrays, or sklearn's ``tree_`` objects) is laid out compactly
(``_walk_arrays``) and scored by one design: each (draw, row) lane walks
each tree from its root to a leaf, and the trees' leaf fractions are summed
in tree order. On a CUDA device the hand-written walk kernel
(``csrc/forest_apply.cu``) runs it; elsewhere ``_apply_walk``, its plain
version, which descends every tree at once and is what the tests hold the
kernel against. With row permutations and column masks
(:meth:`DeviceForest.apply_permuted`) a draw reads its permuted columns in
place, so the permutation sweep makes no permuted copy of the rows.

Thresholds are the largest f32 at or below sklearn's f64 threshold, so
``x <= t32`` takes sklearn's branch for every f32 ``x``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from tpumcia_torch.models.forest_fit import Tree
from tpumcia_torch.models.scaler import MinMaxScaler
from tpumcia_torch.utils.device import require_device
from tpumcia_torch.utils.profiling import COUNTERS, trace

# (tree, lane) pairs the plain walk descends at once
_WALK_PAIRS = 1 << 24


def _thr_f32_floor(thr_f64: np.ndarray) -> np.ndarray:
    """f64 split thresholds -> the largest f32 <= each threshold, so that
    ``x <= t32`` equals ``x <= thr_f64`` for every f32 ``x``."""
    t32 = np.asarray(thr_f64).astype(np.float32)
    up = t32.astype(np.float64) > np.asarray(thr_f64)
    return np.where(up, np.nextafter(t32, np.float32(-np.inf)), t32)


def _leaf_fractions(tree) -> np.ndarray:
    """(n, K) class fractions of a tree's nodes (sklearn >= 1.4 stores
    fractions already; the division keeps older count layouts right)."""
    vals = np.asarray(tree.value)[:, 0, :]
    sums = vals.sum(axis=1, keepdims=True)
    sums[sums == 0] = 1
    return vals / sums


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
    row n. Every (tree, draw, row) pair steps down one level at a time
    (left iff ``x <= threshold``, so NaN goes right) until each sits on a
    leaf, ``_WALK_PAIRS`` pairs at once; the trees' leaf fractions are then
    summed in tree order in f32 and divided by T (on a CUDA device PyTorch
    multiplies by 1/T), as the kernel does."""
    N, F = X.shape
    T = roots.shape[0]
    D = 1 if perms is None else perms.shape[0]
    if perms is not None:
        permuted = masks.to(torch.bool)[torch.arange(D, device=X.device) // repeats]
    feature, left, right = nodes[:, 0].long(), nodes[:, 2].long(), nodes[:, 3].long()
    threshold = nodes[:, 1].view(torch.float32)
    out = torch.empty((D * N, values.shape[1]), dtype=torch.float32, device=X.device)
    step = max(1, _WALK_PAIRS // max(1, T))
    for l0 in range(0, D * N, step):
        L = min(step, D * N - l0)
        node = roots.long().repeat_interleave(L)  # pair p: tree p // L, lane l0 + p % L
        live = torch.arange(T * L, device=X.device)
        while live.numel():
            at = node[live]
            f = feature[at]
            inner = f >= 0
            live, at, f = live[inner], at[inner], f[inner]
            lane = l0 + live % L
            row = lane % N
            if perms is not None:
                draw = lane // N
                row = torch.where(permuted[draw, f], perms[draw, row], row)
            node[live] = torch.where(X[row, f] <= threshold[at], left[at], right[at])
        leaf = values[left[node]].view(T, L, -1)
        total = leaf[0].clone()
        for t in range(1, T):
            total += leaf[t]
        out[l0:l0 + L] = total / T
    return out.view(D, N, -1)


def _launch_walk(X, perms, masks, repeats, nodes, roots, values, n_features):
    """The walk kernel on the card: the arguments and result of
    :func:`_apply_walk`, ``masks`` as (G, F) uint8. Adds its launch to
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
    COUNTERS["forest_kernel_launches"] += 1
    return out


@dataclass
class DeviceForest:
    # the walk layout (``_walk_arrays``)
    nodes: torch.Tensor  # (M, 4) int32
    roots: torch.Tensor  # (T,) int32
    values: torch.Tensor  # (U, K) f32
    n_features: int
    classes: np.ndarray
    scaler: MinMaxScaler | None = None

    @classmethod
    @trace("forest_layout")
    def from_arrays(cls, trees, classes, scaler: MinMaxScaler | None = None, *,
                    device="cuda") -> "DeviceForest":
        """Lay out fitted trees (:class:`Tree` or sklearn ``tree_`` objects,
        read by duck typing) on ``device``, in one ``forest_layout`` span."""
        require_device(device, "DeviceForest.from_arrays")
        nodes, roots, values, n_features = _walk_arrays(trees)
        return cls(nodes=torch.from_numpy(nodes).to(device), roots=torch.from_numpy(roots).to(device),
                   values=torch.from_numpy(values).to(device), n_features=n_features,
                   classes=np.asarray(classes), scaler=scaler)

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
        return self.nodes.device

    def apply_fn(self):
        """tpumcia's scoring callable: ``f(X_scaled)``, (..., F) scaled f32
        features on the forest's device -> (..., K) mean class
        probabilities (:meth:`apply`)."""
        return self.apply

    @trace("forest_apply")
    def apply(self, X: torch.Tensor) -> torch.Tensor:
        """(..., F) scaled f32 features -> (..., K) mean class probabilities:
        the walk kernel on a CUDA device, else its plain version; one
        ``forest_apply`` span, its (tree, row) pairs added to
        ``COUNTERS["forest_lanes"]``."""
        lead = X.shape[:-1]
        x = X.reshape(-1, X.shape[-1])
        COUNTERS["forest_lanes"] += self.roots.shape[0] * x.shape[0]
        if self.device.type == "cuda":
            p = _launch_walk(x.contiguous(), None, None, 1, self.nodes, self.roots, self.values,
                             self.n_features)[0]
        else:
            p = _apply_walk(x, self.nodes, self.roots, self.values)[0]
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
        CUDA device, else its plain version; one ``forest_apply`` span, its
        (tree, draw, row) lanes added to ``COUNTERS["forest_lanes"]``."""
        COUNTERS["forest_lanes"] += self.roots.shape[0] * perms.numel()
        if self.device.type == "cuda":
            return _launch_walk(X.contiguous(), perms.contiguous(),
                                (masks != 0).to(torch.uint8).contiguous(), repeats,
                                self.nodes, self.roots, self.values, self.n_features)
        return _apply_walk(X, self.nodes, self.roots, self.values, perms, masks, repeats)

    def kernel_launch_info(self, lanes: int) -> dict:
        """How the walk kernel would launch over ``lanes`` (draw, row) lanes
        of this CUDA forest: threads a block, dynamic shared memory bytes (0
        where the forest is read from device memory), resident blocks per SM,
        whether the forest sits in shared memory, and the grid."""
        from tpumcia_torch import _build

        info = (ctypes.c_int * 5)()
        with torch.cuda.device(self.device):
            _build.check(_build.load_library().tpumcia_forest_launch_info(
                self.nodes.shape[0], self.values.shape[0], self.values.shape[1], self.roots.shape[0],
                lanes, info),
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
