"""End-to-end pipeline on one device (counterpart of
``tpumcia.pipeline.run``):

    (synthesize noise channels) -> extract features -> split -> scale ->
    fit head -> classification report -> feature + channel importance

Only the fused fast path is ported: per-batch extraction (masked or not)
with a device-resident f32 feature block, then the logistic fit and both
permutation sweeps on that block. A configuration the fast path does not
take (tpumcia sends it to its classic pipeline) raises
``NotImplementedError`` naming the ROADMAP item that will port it; nothing
falls back to another path or to the CPU.
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
from tpumcia_torch.importance.channels import ChannelImportanceResult
from tpumcia_torch.utils.metrics import accuracy, classification_report
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


def _fast_path_block(cfg: PipelineConfig, images) -> str | None:
    """None when the fused fast path takes this run (tpumcia's
    ``_fast_path_ok`` without the mesh branch); else what the run needs that
    is not ported, with the ROADMAP item that ports it."""
    if cfg.fast_path == "never":
        return "the classic unfused pipeline, fast_path='never' (ROADMAP A10)"
    if cfg.head.kind != "logistic":
        return f"head kind {cfg.head.kind!r} (ROADMAP A10)"
    if cfg.normalize != "minmax":
        return f"normalize={cfg.normalize!r} (ROADMAP A10)"
    if cfg.importance.channel_match != "exact":
        return "substring channel matching (ROADMAP A10)"
    if cfg.importance.channel_method != "permutation":
        return f"channel_method={cfg.importance.channel_method!r} (ROADMAP A10)"
    if not batched_fast_path_ok(images.shape, cfg.features):
        return (
            "the classic unfused pipeline that tpumcia runs for feature config "
            f"precision={cfg.features.precision!r}, "
            f"offsets={cfg.features.glcm.offsets}, "
            f"morphology={cfg.features.include_morphology}, levels="
            f"{cfg.features.glcm.levels}, image shape {tuple(images.shape)} "
            "(ROADMAP A10; morphology A9; extract_features takes the other "
            "feature configs)"
        )
    if cfg.fast_path != "always" and len(images) <= 4096:
        return (
            "the classic pipeline that fast_path='auto' picks for <= 4096 "
            "images (ROADMAP A10); set fast_path='always'"
        )
    return None


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
    if timer is not None:
        timer.stamp("head_sweeps")
    fm = pending.result()  # the wires' device-to-host copies + f64 assembly
    timings["features_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    res = fit_pending.result()  # the one packed head/sweep copy
    if timer is not None:
        timer.stamp("d2h_assembly")
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


def run_pipeline(
    images,
    labels,
    *,
    device,
    mask=None,
    config: PipelineConfig | None = None,
    channel_names: list[str] | None = None,
    groups: np.ndarray | None = None,
    timer=None,
) -> PipelineResult:
    """Run the full analysis on a batch of level-quantised images on
    ``device`` (a CUDA device for the kernel; a CPU device runs the kernel's
    plain version).

    With ``config.synth.noise_channels > 0``, ``images`` is a (B, H, W)
    grayscale batch and the noise channels are synthesized on the device;
    otherwise it is (B, H, W, C). ``mask``: optional (B, H, W) mask shared
    by every channel or (B, H, W, C), nonzero selects a pixel (numpy or a
    tensor, e.g. already on the device; not with noise channels).
    ``groups``: per-object group ids for a grouped split. ``timer``: an
    optional ``utils.profiling.StageTimer`` that splits the run into inputs
    (host-to-device copies and the mask layout), synth, stats kernel, wire +
    f32 features, head + sweeps and device-to-host + assembly.
    """
    cfg = coerce_config(config)
    device = torch.device(device)
    labels = np.asarray(labels)

    if cfg.mesh.data > 1 or cfg.mesh.model > 1:
        raise NotImplementedError(
            f"multi-device mesh {cfg.mesh} is not ported yet (ROADMAP A14); "
            "tpumcia_torch runs on the one device it is given"
        )
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
    blocked = _fast_path_block(cfg, images_arr)
    if blocked is not None:
        raise NotImplementedError(
            f"tpumcia_torch runs only the fused fast path; this run needs {blocked}"
        )
    return _run_pipeline_fast(
        images_arr, labels, mask=mask, cfg=cfg, channel_names=channel_names,
        groups=groups, device=device, timer=timer,
    )
