"""End-to-end pipeline (counterpart of ``tpumcia.pipeline.run``):

    (synthesize noise channels) -> extract features -> split -> scale ->
    fit head -> classification report -> feature + channel importance

Two paths, picked as tpumcia picks them (:func:`_fast_path_ok`):

- the fused fast path: per-batch extraction (masked or not) with a
  device-resident f32 feature block, then the logistic fit and both
  permutation sweeps on that block;
- the classic path, for every other configuration: channels-last noise
  synthesis, ``extract_features(_batched)``, the features on the host as
  f32, the split, ``fit_head`` and ``channel_importance`` for the channel
  and the per-feature view, with the feature matrix copied to the device
  once for the head and both sweeps.

``config.mesh`` is resolved against the device pool (``device``: one
device or a sequence, ``parallel.mesh.device_pool``), as tpumcia resolves it
against ``jax.devices()``: on one device it is None and nothing changes;
over several slots the classic path runs with the extraction, the scaler's
min/max and both permutation sweeps over the mesh (``parallel.sharding``)
and the head fitted on the first slot's device. Nothing falls back to the
CPU: the random-forest head is fitted on the device too.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from tpumcia_torch.config import PipelineConfig, coerce_config
from tpumcia_torch.features.extract import (
    FeatureMatrix,
    batched_fast_path_ok,
    check_use_pallas,
)
from tpumcia_torch.importance.channels import ChannelImportanceResult, channel_importance
from tpumcia_torch.utils.device import require_device
from tpumcia_torch.utils.metrics import accuracy, classification_report
from tpumcia_torch.utils.profiling import ROOT_SPAN, stage, trace
from tpumcia_torch.utils.split import train_test_split_indices

# every ImportanceConfig.channel_method the JAX package knows
_CHANNEL_METHODS = ("auto", "mdi", "coef", "permutation", "permutation_features", "ablation")


@dataclass
class PipelineResult:
    features: FeatureMatrix
    head: Any
    test_accuracy: float
    report: str
    channel_result: ChannelImportanceResult
    feature_result: ChannelImportanceResult | None
    train_idx: np.ndarray
    test_idx: np.ndarray
    timings: dict[str, float] = field(default_factory=dict)

    def summary(self) -> str:
        lines = [
            f"objects: {len(self.features)}  features: {self.features.shape[1]}",
            f"test accuracy: {self.test_accuracy:.4f}",
            self.channel_result.summary(),
        ]
        return "\n".join(lines)


def _fast_path_ok(cfg: PipelineConfig, images, mask, mesh=None) -> bool:
    """tpumcia's ``_fast_path_ok``: the fused path takes a logistic head on
    MinMax features with grouped permutation importance, on the hybrid
    u32-wire feature config, for more than 4096 images (or
    ``fast_path='always'``), on one device."""
    if mesh is not None:
        if cfg.fast_path == "always":
            # never silently downgrade an explicit request: the fused path
            # is single-device by design; a mesh runs the sharded classic path
            raise ValueError(
                "fast_path='always' is single-device but the mesh config "
                f"resolved {mesh.shape}; set mesh data=1/model=1 (or "
                "fast_path='auto')"
            )
        return False
    if cfg.fast_path == "never":
        return False
    if cfg.head.kind != "logistic" or cfg.normalize != "minmax":
        return False
    if cfg.importance.channel_match != "exact":
        return False
    if cfg.importance.channel_method != "permutation":
        return False
    if cfg.synth.noise_channels > 0 and (images.ndim != 3 or mask is not None):
        return False
    if cfg.synth.noise_channels == 0 and images.ndim != 4:
        return False
    if not batched_fast_path_ok(images.shape, cfg.features):
        return False
    return cfg.fast_path == "always" or len(images) > 4096


def _run_pipeline_fast(
    images, labels, *, mask, cfg, channel_names, groups, device, timer
) -> PipelineResult:
    from tpumcia_torch.features import registry
    from tpumcia_torch.features.extract import extract_features_pending
    from tpumcia_torch.models.fused import fit_logistic_with_importance

    timings: dict[str, float] = {}
    t0 = time.perf_counter()
    pending = extract_features_pending(
        images, mask,
        device=device, batch_size=cfg.batch_size, config=cfg.features,
        channel_names=channel_names, keep_device_values=True,
        synth_noise=cfg.synth.noise_channels, synth_var=cfg.synth.var,
        synth_seed=cfg.synth.seed, timer=timer,
    )
    with stage("head_sweeps", timer):
        split = train_test_split_indices(
            pending.n,
            test_size=cfg.split.test_size,
            seed=cfg.split.seed,
            stratify=labels if cfg.split.stratify else None,
            groups=groups if cfg.split.group_by else None,
        )
        fit_pending = fit_logistic_with_importance(
            pending.device_values, labels,
            train_idx=split.train_idx, test_idx=split.test_idx,
            groups=registry.columns_by_channel_positional(pending.num_channels),
            names=pending.names,
            head_config=cfg.head, importance_config=cfg.importance,
            channel_names=pending.channel_names, defer=True,
        )
    with stage("d2h_assembly", timer):
        fm = pending.result()  # the wires' device-to-host copies + f64 assembly
        timings["features_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        res = fit_pending.result()  # the one packed head/sweep copy
    y_te = labels[split.test_idx]
    test_acc = accuracy(y_te, res.y_pred)
    report = classification_report(y_te, res.y_pred)
    timings["fit_s"] = time.perf_counter() - t0
    timings["importance_s"] = 0.0  # inside the fit's device work

    return PipelineResult(
        features=fm,
        head=res.head,
        test_accuracy=test_acc,
        report=report,
        channel_result=res.channel_result,
        feature_result=res.feature_result,
        train_idx=split.train_idx,
        test_idx=split.test_idx,
        timings=timings,
    )


@trace(ROOT_SPAN)
def run_pipeline(
    images,
    labels,
    *,
    device="cuda",
    mask=None,
    config: PipelineConfig | None = None,
    channel_names: list[str] | None = None,
    groups: np.ndarray | None = None,
    timer=None,
) -> PipelineResult:
    """Run the full analysis on a batch of level-quantised images on
    ``device`` (a CUDA device for the kernel; a CPU device runs the kernel's
    plain version), or on a pool of devices (a sequence; a bare ``"cuda"`` is
    every visible card) that ``config.mesh`` is resolved against.

    With ``config.synth.noise_channels > 0``, ``images`` is a (B, H, W)
    grayscale batch and the noise channels are synthesized on the device;
    otherwise it is (B, H, W, C). ``mask``: optional (B, H, W) mask shared
    by every channel or (B, H, W, C), nonzero selects a pixel (numpy or a
    tensor, e.g. already on the device; not with noise channels).
    ``groups``: per-object group ids for a grouped split. ``timer``: an
    optional ``utils.profiling.StageTimer`` that splits the run into stages:
    on the fast path inputs (host-to-device copies and the mask layout),
    synth, stats kernel, wire + f32 features, head + sweeps and
    device-to-host + assembly; on the classic path synth, inputs, stats
    kernel, finalize (per batch), the host matrix and its upload, head and
    importance. Each stage is also a span of the stage's name, inside the
    call's ``run_pipeline`` span, with or without a timer
    (``utils.profiling``).

    The configurations tpumcia's fast path takes run fused (see
    :func:`_fast_path_ok`); every other one runs tpumcia's classic path.
    """
    from tpumcia_torch.parallel.mesh import device_pool, mesh_from_config

    require_device(device, "run_pipeline")
    cfg = coerce_config(config)
    pool = device_pool(device)
    mesh = mesh_from_config(cfg.mesh, pool)
    if mesh is not None:
        device = mesh.first_device
    else:
        device = pool[0] if isinstance(device, (list, tuple)) else torch.device(device)
    labels = np.asarray(labels)

    if cfg.split.group_by and groups is None:
        # an ungrouped split would leak groups (donors) across train/test
        raise ValueError(
            f"split.group_by={cfg.split.group_by!r} but no groups were "
            "provided — pass groups= or clear split.group_by"
        )
    if cfg.synth.noise_channels > 0 and mask is not None:
        raise ValueError(
            "synth.noise_channels does not compose with masks: noise "
            "channels are synthesized full-frame (the reference's "
            "add_two_noise_channels has no mask concept, ipynb:148-156)"
        )
    if cfg.importance.channel_method not in _CHANNEL_METHODS:
        raise ValueError(
            f"unknown importance.channel_method "
            f"{cfg.importance.channel_method!r}; one of {_CHANNEL_METHODS}"
        )
    check_use_pallas(cfg.features, device)

    images_arr = images if hasattr(images, "shape") else np.asarray(images)
    want_ndim = 3 if cfg.synth.noise_channels > 0 else 4
    if images_arr.ndim != want_ndim:
        expected = "(B, H, W) grayscale (synth.noise_channels > 0)" \
            if want_ndim == 3 else "(B, H, W, C)"
        raise ValueError(
            f"run_pipeline expects {expected} images; got shape "
            f"{tuple(images_arr.shape)}"
        )
    n_objects = images_arr.shape[0]
    if n_objects == 0:
        raise ValueError("run_pipeline needs at least one image; got 0")
    if labels.shape[:1] != (n_objects,):
        raise ValueError(
            f"labels length {labels.shape[0] if labels.ndim else 0} does "
            f"not match the {n_objects} images"
        )
    if groups is not None and np.asarray(groups).shape[:1] != (n_objects,):
        raise ValueError(
            f"groups length {len(np.asarray(groups))} does not match the "
            f"{n_objects} images"
        )
    if _fast_path_ok(cfg, images_arr, mask, mesh):
        return _run_pipeline_fast(
            images_arr, labels, mask=mask, cfg=cfg, channel_names=channel_names,
            groups=groups, device=device, timer=timer,
        )
    return _run_pipeline_classic(
        images_arr, labels, mask=mask, cfg=cfg, channel_names=channel_names,
        groups=groups, device=device, timer=timer, mesh=mesh,
    )


def _run_pipeline_classic(
    images, labels, *, mask, cfg, channel_names, groups, device, timer, mesh=None
) -> PipelineResult:
    """tpumcia's classic branch (``pipeline/run.py:229-346``); with a
    ``mesh``, the whole collection's statistics in one launch a slot, the
    scaler's min/max and both sweeps over it, and the head on ``device``,
    the first slot's."""
    from tpumcia_torch.features.extract import _extract_features, _extract_features_batched
    from tpumcia_torch.models.heads import RandomForestHead, fit_head

    timings: dict[str, float] = {}
    if timer is not None:
        timer.start()
    if cfg.synth.noise_channels > 0:
        from tpumcia_torch.preprocess.synth import add_noise_channels_batched

        # the fast path's per-batch stream: the same dataset on either path
        with stage("synth", timer):
            images = add_noise_channels_batched(
                images, seed=cfg.synth.seed, batch_size=cfg.batch_size, device=device,
                num_noise=cfg.synth.noise_channels, var=cfg.synth.var,
            )

    t0 = time.perf_counter()
    kw = dict(device=device, config=cfg.features, channel_names=channel_names, timer=timer)
    if mesh is None and len(images) > 4096:
        fm = _extract_features_batched(images, mask, batch_size=cfg.batch_size, **kw)
    else:
        fm = _extract_features(images, mask, mesh=mesh, **kw)
    timings["features_s"] = time.perf_counter() - t0

    # over a mesh the statistics were gathered over the ranks before the
    # finalize: every rank holds the whole matrix (tpumcia's fetch_to_host)
    with stage("host_matrix_upload", timer):
        X_host = np.nan_to_num(np.asarray(fm.to_numpy(), dtype=np.float32))
        split = train_test_split_indices(
            len(X_host),
            test_size=cfg.split.test_size,
            seed=cfg.split.seed,
            stratify=labels if cfg.split.stratify else None,
            groups=groups if cfg.split.group_by else None,
        )
        X = torch.from_numpy(X_host).to(device)  # one copy for the head and both sweeps
        tr = torch.as_tensor(split.train_idx, device=device)
        te = torch.as_tensor(split.test_idx, device=device)

    with stage("head", timer):
        t0 = time.perf_counter()
        scaler = None
        if mesh is not None and cfg.normalize == "minmax":
            from tpumcia_torch.parallel.sharding import fit_scaler_sharded

            scaler = fit_scaler_sharded(X_host[split.train_idx], mesh=mesh)
        head = fit_head(
            X[tr], labels[split.train_idx], device=device, config=cfg.head,
            scale=cfg.normalize == "minmax", scaler=scaler,
        )
        timings["fit_s"] = time.perf_counter() - t0
        y_te = labels[split.test_idx]
        pred = head.predict(X[te])
        test_acc = accuracy(y_te, pred)
        report = classification_report(y_te, pred)

    fm_test = FeatureMatrix(
        values=X_host[split.test_idx],
        names=fm.names,
        num_channels=fm.num_channels,
        config=fm.config,
        channel_names=fm.channel_names,
        device_values=X[te],
    )
    with stage("importance", timer):
        t0 = time.perf_counter()
        channel_res = channel_importance(
            head, fm_test, y_te, method=cfg.importance.channel_method, config=cfg.importance,
            mesh=mesh,
        )
        # the per-feature view (notebook cell 28, ipynb:493-505): MDI for a
        # forest, the per-feature permutation sweep otherwise
        feature_method = "mdi" if isinstance(head, RandomForestHead) else "permutation_features"
        feature_res = channel_importance(
            head, fm_test, y_te, method=feature_method, config=cfg.importance, mesh=mesh,
        )
        timings["importance_s"] = time.perf_counter() - t0

    return PipelineResult(
        features=fm,
        head=head,
        test_accuracy=test_acc,
        report=report,
        channel_result=channel_res,
        feature_result=feature_res,
        train_idx=split.train_idx,
        test_idx=split.test_idx,
        timings=timings,
    )
