"""Batched permutation feature importance on the device (counterpart of
``tpumcia.importance.permutation``).

Semantics match sklearn's ``permutation_importance``:
``importance[g, r] = baseline_score - score(X with group g's columns
permuted jointly by permutation r)``, scores being mean accuracy. The G*R
permuted copies are scored in batched gathers + matmuls, unless the
scorer gives the sweep its outputs itself (a forest head's reads the draws
in place, through :meth:`DeviceForest.apply_permuted`). The
permutations are an input: :func:`draw_permutations` draws them from a
seeded ``torch.Generator``, and the tests hand in the JAX package's own.
:func:`permutation_importance` is the entry for a fitted logistic, MLP or
forest head (a forest is scored by its ``DeviceForest`` on the head's
device, and the sweep takes the argmax of its class probabilities).
:func:`permutation_importance_host` is a numpy copy of sklearn's own
algorithm, scoring with ``head.score``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from tpumcia_torch.utils.profiling import COUNTERS, trace

# elements of the (draws, N, F) permuted stack scored at once
_SWEEP_CHUNK_ELEMS = 1 << 28


def labels_to_class_idx(labels, classes) -> np.ndarray:
    """Labels -> class indices, with -1 for a label never seen in training
    (argmax is always in [0, k), so such rows score as mispredictions)."""
    mapping = {c: i for i, c in enumerate(np.asarray(classes).tolist())}
    return np.array(
        [mapping.get(v, -1) for v in np.asarray(labels).tolist()], np.int32
    )


def group_masks(groups, num_features: int) -> np.ndarray:
    """(G, F) f32 joint-shuffle masks from per-group column lists
    (``None`` -> identity = the per-feature sweep)."""
    if groups is None:
        return np.eye(num_features, dtype=np.float32)
    masks = np.zeros((len(groups), num_features), np.float32)
    for g, cols in enumerate(groups):
        masks[g, cols] = 1.0
    return masks


@dataclass
class PermutationResult:
    importances: np.ndarray  # (F, R) score drops
    importances_mean: np.ndarray  # (F,)
    importances_std: np.ndarray  # (F,)
    baseline_score: float
    # a forest's sweep only: (F, R) drops of the rows' mean share of their
    # true class (0 for a label never seen in training), and that mean
    # share unpermuted
    share_importances: np.ndarray | None = None
    baseline_share: float | None = None

    def ranking(self) -> np.ndarray:
        """Feature indices sorted by mean importance, descending."""
        return np.argsort(self.importances_mean)[::-1]


def check_n_repeats(n_repeats) -> int:
    """n_repeats=0 would mean-reduce an empty axis into all-NaN importances."""
    n = int(n_repeats)
    if n < 1:
        raise ValueError(f"n_repeats must be >= 1; got {n_repeats!r}")
    return n


def _scaled_logistic_apply(params, dmin, dscale, X):
    return (X - dmin) * dscale @ params["w"] + params["b"]


def _scaled_mlp_apply(params, dmin, dscale, X):
    from tpumcia_torch.models.heads import mlp_predict_logits

    return mlp_predict_logits(params, (X - dmin) * dscale)


@dataclass
class _ScaledForest:
    """A forest head's scoring callable: raw (N, F) rows -> the class
    probabilities of its forest on the scaled rows. It gives a sweep its
    outputs itself, reading the draws in place (:meth:`sweep_outputs`), and
    its outputs are class probabilities, so the sweep also reads the true
    class's share."""

    forest: object  # DeviceForest
    dmin: torch.Tensor
    dscale: torch.Tensor
    probabilities = True

    def __call__(self, X):
        return self.forest.apply((X - self.dmin) * self.dscale)

    def sweep_outputs(self, X, masks, perms):
        """Yields the (N, K) output on X, then the (g * R, N, K) outputs of
        perms' (G, R, N) draws, whole groups at a time, all from the rows
        scaled once (scaling is per element, so that gives each permuted
        copy's floats)."""
        G, R, N = perms.shape
        Xs = (X - self.dmin) * self.dscale
        yield self.forest.apply(Xs)
        step = max(1, _SWEEP_CHUNK_ELEMS // max(1, R * N * self.forest.values.shape[1]))
        for g in range(0, G, step):
            yield self.forest.apply_permuted(Xs, perms[g:g + step].reshape(-1, N), masks[g:g + step], R)


def _permuted_copies(apply_fn, X, masks, perms):
    """Yields ``apply_fn``'s output on X, then its outputs on the permuted
    copies ``torch.where(permuted, X[perm], X)`` of perms' (G, R, N) draws,
    ``_SWEEP_CHUNK_ELEMS // (N * F)`` draws at a time."""
    yield apply_fn(X)
    N, F = X.shape
    G, R, _ = perms.shape
    flat = perms.reshape(G * R, N)
    group_of = torch.arange(G, device=X.device).repeat_interleave(R)
    permuted = masks[group_of].to(torch.bool)[:, None, :]  # (G*R, 1, F)
    step = max(1, _SWEEP_CHUNK_ELEMS // max(1, N * F))
    for s in range(0, G * R, step):
        yield apply_fn(torch.where(permuted[s:s + step], X[flat[s:s + step]], X))


def _device_score_parts(head):
    """(apply_fn, classes) of a fitted head: ``apply_fn(X)`` gives the
    logits (class probabilities for a forest) of raw (unscaled) X on the
    head's device."""
    from tpumcia_torch.models.forest_device import DeviceForest
    from tpumcia_torch.models.heads import LogisticHead, MLPHead, RandomForestHead

    if isinstance(head, RandomForestHead):
        head = head.to_device()
    apply = {LogisticHead: _scaled_logistic_apply, MLPHead: _scaled_mlp_apply,
             DeviceForest: _ScaledForest}.get(type(head))
    if apply is None:
        raise TypeError(
            f"head {type(head).__name__} has no device scoring path; use "
            "permutation_importance_host"
        )
    if head.scaler is None:
        dmin, dscale = torch.zeros((), device=head.device), torch.ones((), device=head.device)
    else:
        dmin, dscale = head.scaler.data_min, head.scaler.scale
    if isinstance(head, DeviceForest):
        return _ScaledForest(head, dmin, dscale), head.classes
    return functools.partial(apply, head.params, dmin, dscale), head.classes


def draw_permutations(
    num_draws: int, n: int, *, seed: int, device
) -> torch.Tensor:
    """(num_draws, n) int64: independent uniform permutations of range(n),
    drawn from ``torch.Generator(device).manual_seed(seed)`` as the argsort
    of float64 uniforms (ties have probability ~n^2 * 2^-54)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    u = torch.rand((num_draws, n), generator=gen, dtype=torch.float64, device=device)
    return torch.argsort(u, dim=1)


def _perm_sweep(X, y_idx, masks, perms, apply_fn, *, shares=False):
    """X (N, F); y_idx (N,) class indices; masks (G, F) 0/1 columns permuted
    jointly per group; perms (G, R, N) row permutations. Returns
    (baseline accuracy, (G, R) accuracy drops); with ``shares`` (``apply_fn``
    gives class probabilities, as a forest's does) also (the baseline's mean
    share of the true class, (G, R) drops of that share). The sweep is one
    ``sweep`` span and adds its G*R + 1 evaluations to
    ``COUNTERS["sweep_evals"]``. A scorer with a ``sweep_outputs`` method
    gives the outputs itself (a forest reads the draws in place); any other
    callable is scored on permuted copies of X."""
    G, R, _ = perms.shape

    def score(out):  # (..., N, k) -> (...) accuracy, or (..., 2) with the true class's share
        acc = (torch.argmax(out, dim=-1) == y_idx).to(torch.float32).mean(-1)
        if not shares:
            return acc
        true = torch.gather(out, -1, y_idx.clamp(min=0).expand(out.shape[:-1])[..., None])
        share = torch.where(y_idx >= 0, true[..., 0], 0.0).mean(-1)
        return torch.stack([acc, share], -1)

    with trace("sweep"):
        outputs = getattr(apply_fn, "sweep_outputs", None) or functools.partial(_permuted_copies, apply_fn)
        baseline, *scores = (score(out) for out in outputs(X, masks, perms))
        scores = torch.cat([X.new_zeros((0, *baseline.shape))] + scores)
    COUNTERS["sweep_evals"] += G * R + 1
    drops = baseline - scores.reshape(G, R, *baseline.shape)
    if shares:
        return baseline[0], drops[..., 0], baseline[1], drops[..., 1]
    return baseline, drops


def _run_sweep(head, X, y, masks, *, n_repeats, seed) -> PermutationResult:
    R = check_n_repeats(n_repeats)
    apply_fn, classes = _device_score_parts(head)
    dev = head.device
    X = torch.as_tensor(X, dtype=torch.float32, device=dev)
    y_idx = torch.as_tensor(labels_to_class_idx(y, classes), dtype=torch.int64, device=dev)
    G, N = masks.shape[0], X.shape[0]
    perms = draw_permutations(G * R, N, seed=seed, device=dev).reshape(G, R, N)
    with torch.no_grad():
        baseline, drops, *share = _perm_sweep(
            X, y_idx, torch.as_tensor(masks, device=dev), perms, apply_fn,
            shares=getattr(apply_fn, "probabilities", False),
        )
    imp = drops.cpu().numpy().astype(np.float64)
    return PermutationResult(
        importances=imp,
        importances_mean=imp.mean(axis=1),
        importances_std=imp.std(axis=1),
        baseline_score=float(baseline),
        share_importances=share[1].cpu().numpy().astype(np.float64) if share else None,
        baseline_share=float(share[0]) if share else None,
    )


def permutation_importance(
    head,
    X,
    y,
    *,
    n_repeats: int = 10,
    seed: int = 42,
    groups: list[list[int]] | None = None,
) -> PermutationResult:
    """sklearn-shaped permutation importance on the head's device
    (tpumcia's ``permutation_importance``): ``X`` (numpy or a tensor, kept
    where it is when it is already on that device), ``groups`` (column
    lists) permuted jointly, each group's ``n_repeats`` permutations drawn by
    :func:`draw_permutations` from ``seed``. Defaults mirror the reference
    call (n_repeats=10, random_state=42, ipynb:495-496)."""
    masks = group_masks(groups, X.shape[1])
    return _run_sweep(head, X, y, masks, n_repeats=n_repeats, seed=seed)


def permutation_importance_host(
    head,
    X,
    y,
    *,
    n_repeats: int = 10,
    seed: int = 42,
) -> PermutationResult:
    """sklearn's ``permutation_importance(head, X, y, n_repeats=n_repeats,
    random_state=seed)`` with ``head.score`` as the scorer (tpumcia's
    ``permutation_importance_host``), as numpy: one seed drawn with
    ``RandomState(seed).randint(2**31)``; per column, a fresh
    ``RandomState`` from it shuffles the row index in place ``n_repeats``
    times, and each shuffle is applied to the column of a copy in turn, so
    the shuffles compound as in sklearn."""
    R = check_n_repeats(n_repeats)
    X = X.cpu().numpy() if isinstance(X, torch.Tensor) else np.asarray(X)
    y = np.asarray(y)
    baseline = float(head.score(X, y))
    col_seed = np.random.RandomState(seed).randint(np.iinfo(np.int32).max + 1)
    scores = np.empty((X.shape[1], R))
    for col in range(X.shape[1]):
        rng = np.random.RandomState(col_seed)
        X_perm = X.copy()
        idx = np.arange(X.shape[0])
        for r in range(R):
            rng.shuffle(idx)
            X_perm[:, col] = X_perm[idx, col]
            scores[col, r] = head.score(X_perm, y)
    imp = baseline - scores
    return PermutationResult(
        importances=imp,
        importances_mean=imp.mean(axis=1),
        importances_std=imp.std(axis=1),
        baseline_score=baseline,
    )
