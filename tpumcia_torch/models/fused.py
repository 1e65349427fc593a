"""Logistic head fit + permutation importance sweeps on the device-resident
feature matrix, returned in one packed device-to-host copy (counterpart of
``tpumcia.models.fused``).

take -> MinMax fit/transform -> logistic fit -> grouped (per-channel) and
per-feature permutation sweeps -> test predictions, all on the device; the
host-bound scalars come back as one float32 vector. Reference mapping:
cells 19-20 (split/scale/fit, ipynb:381-417) + cell 28 (permutation
importance, ipynb:493-505).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from tpumcia_torch.config import HeadConfig, ImportanceConfig
from tpumcia_torch.importance.channels import (
    ChannelImportanceResult,
    aggregate_channel_importance,
)
from tpumcia_torch.importance.permutation import (
    PermutationResult,
    _perm_sweep,
    _scaled_logistic_apply,
    check_n_repeats,
    draw_permutations,
    group_masks as build_group_masks,
    labels_to_class_idx,
)
from tpumcia_torch.models.heads import LogisticHead, _fit_logistic, init_weights
from tpumcia_torch.models.scaler import MinMaxScaler, minmax_scale


def _fused_fit_sweeps(
    X, tr_idx, te_idx, y_tr_onehot, y_te_idx, group_masks, w0, b0,
    perms_g, perms_f, *, num_steps, lr, l2,
):
    """take -> MinMax -> logistic fit -> grouped + per-feature sweeps ->
    test predictions. ``perms_g`` (G, R, N_test) and ``perms_f``
    (F, R, N_test) are the sweeps' row permutations. Returns (packed f32
    vector for the host, fitted params on the device)."""
    F = X.shape[1]
    X_tr = X[tr_idx]
    X_te = X[te_idx]
    dmin = X_tr.amin(0)
    dmax = X_tr.amax(0)
    dscale = minmax_scale(dmin, dmax)
    params = _fit_logistic(
        (X_tr - dmin) * dscale, y_tr_onehot, w0, b0,
        num_steps=num_steps, lr=lr, l2=l2,
    )
    apply_fn = functools.partial(_scaled_logistic_apply, params, dmin, dscale)
    baseline, imp_g = _perm_sweep(X_te, y_te_idx, group_masks, perms_g, apply_fn)
    eye = torch.eye(F, dtype=torch.float32, device=X.device)
    _, imp_f = _perm_sweep(X_te, y_te_idx, eye, perms_f, apply_fn)
    y_pred = torch.argmax(apply_fn(X_te), dim=-1)
    packed = torch.cat([
        baseline.reshape(1),
        imp_g.reshape(-1),
        imp_f.reshape(-1),
        dmin,
        dmax,
        y_pred.to(torch.float32),
    ])
    return packed, params


@dataclass
class FusedFitResult:
    head: LogisticHead
    channel_result: ChannelImportanceResult
    feature_result: ChannelImportanceResult
    y_pred: np.ndarray  # predicted class labels on the test rows
    baseline_score: float


@dataclass
class PendingFusedFit:
    """Fit + sweeps enqueued on the device; :meth:`result` makes the one
    packed copy to the host."""

    _finish: callable

    def result(self) -> FusedFitResult:
        return self._finish()


def fit_logistic_with_importance(
    X: torch.Tensor,
    labels,
    *,
    train_idx,
    test_idx,
    groups: list[list[int]],
    names: list[str],
    head_config: HeadConfig | None = None,
    importance_config: ImportanceConfig | None = None,
    channel_names: list[str] | None = None,
    defer: bool = False,
    w0: torch.Tensor | None = None,
):
    """Fit the logistic head and compute both importance views on ``X``'s
    device, with one packed copy of the results to the host.

    ``X``: (N, F) f32 device tensor (``FeatureMatrix.device_values``).
    ``groups``: per-channel column index lists. ``w0``: the head's initial
    weights (default :func:`init_weights` from ``head_config.seed``). The
    sweeps' permutations come from :func:`draw_permutations` seeded with
    ``importance_config.seed``; both sweeps start from that one seed.
    ``defer=True`` returns a :class:`PendingFusedFit` before the copy.
    """
    head_cfg = head_config or HeadConfig()
    imp_cfg = importance_config or ImportanceConfig()
    if head_cfg.kind != "logistic":
        raise ValueError("fused fit supports the logistic head")
    R = check_n_repeats(imp_cfg.n_repeats)
    if not isinstance(X, torch.Tensor):
        raise TypeError("X must be a torch tensor on the device the fit runs on")
    dev = X.device
    labels = np.asarray(labels)
    train_idx = np.asarray(train_idx)
    test_idx = np.asarray(test_idx)

    classes, y_tr_idx = np.unique(labels[train_idx], return_inverse=True)
    k = len(classes)
    # a test label never seen in training maps to -1 and scores as a miss
    y_te_idx = labels_to_class_idx(labels[test_idx], classes)
    F = X.shape[1]
    C = len(groups)
    n_te = len(test_idx)

    if w0 is None:
        w0 = init_weights(F, k, seed=head_cfg.seed, device=dev)
    with torch.no_grad():
        packed, params = _fused_fit_sweeps(
            X.to(torch.float32),
            torch.as_tensor(train_idx, device=dev),
            torch.as_tensor(test_idx, device=dev),
            torch.nn.functional.one_hot(
                torch.as_tensor(y_tr_idx, dtype=torch.int64, device=dev), k
            ).to(torch.float32),
            torch.as_tensor(y_te_idx, dtype=torch.int64, device=dev),
            torch.as_tensor(build_group_masks(groups, F), device=dev),
            torch.as_tensor(w0, dtype=torch.float32, device=dev),
            torch.zeros((k,), dtype=torch.float32, device=dev),
            draw_permutations(C * R, n_te, seed=imp_cfg.seed, device=dev).reshape(C, R, n_te),
            draw_permutations(F * R, n_te, seed=imp_cfg.seed, device=dev).reshape(F, R, n_te),
            num_steps=head_cfg.num_steps,
            lr=head_cfg.learning_rate,
            l2=head_cfg.l2,
        )

    def finish() -> FusedFitResult:
        p = packed.cpu().numpy().astype(np.float64)  # the one packed copy
        baseline = float(p[0])
        off = 1
        imp_g = p[off: off + C * R].reshape(C, R)
        off += C * R
        imp_f = p[off: off + F * R].reshape(F, R)
        off += F * R
        dmin = p[off: off + F].astype(np.float32)
        off += F
        dmax = p[off: off + F].astype(np.float32)
        off += F
        y_pred = classes[p[off:].astype(np.int64)]

        head = LogisticHead(
            params["w"], params["b"], classes,
            scaler=MinMaxScaler.from_stats(dmin, dmax, device=dev),
            config=head_cfg,
        )

        def perm_result(imp):
            return PermutationResult(
                importances=imp,
                importances_mean=imp.mean(axis=1),
                importances_std=imp.std(axis=1),
                baseline_score=baseline,
            )

        res_g = perm_result(imp_g)
        total = res_g.importances_mean.copy()
        # a grouped sweep has no per-feature resolution: each channel's mean
        # drop is broadcast onto its columns
        feat_imp = np.zeros(F)
        for c, cols in enumerate(groups):
            feat_imp[cols] = total[c]
        channel_result = ChannelImportanceResult(
            per_channel=[imp_g[c] for c in range(C)],
            mean=total,
            total=total,
            ranking=np.argsort(total)[::-1],
            feature_importances=feat_imp,
            feature_names=list(names),
            method="permutation",
            channel_names=channel_names,
        )
        channel_result.extras["permutation"] = res_g

        res_f = perm_result(imp_f)
        feature_result = aggregate_channel_importance(
            res_f.importances_mean, list(names), C, threshold=None,
            match="exact", method="permutation_features", groups=groups,
        )
        feature_result.channel_names = channel_names
        feature_result.extras["permutation"] = res_f

        return FusedFitResult(
            head=head,
            channel_result=channel_result,
            feature_result=feature_result,
            y_pred=y_pred,
            baseline_score=baseline,
        )

    if defer:
        return PendingFusedFit(_finish=finish)
    return finish()
