"""End-to-end CNN pipeline (BASELINE config 3, counterpart of
``tpumcia.pipeline.run_cnn``): train the ResNet-style classifier on
multichannel images and derive channel importance by occlusion and by
pixel-space permutation: the learned-feature counterpart of
``pipeline/run.py``. It runs on the one device it is given, or over a
device ``mesh`` (``parallel.Mesh``: the fit and the probes split their rows
over its data slots, across processes too; every rank passes the same
images)."""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from tpumcia_torch.importance.channels import ChannelImportanceResult
from tpumcia_torch.importance.occlusion import (
    channel_occlusion_importance,
    channel_permutation_importance_images,
)
from tpumcia_torch.models.train import CNNConfig, CNNHead, fit_cnn, images_on_device
from tpumcia_torch.parallel.mesh import check_mesh
from tpumcia_torch.utils.device import require_device
from tpumcia_torch.utils.metrics import accuracy, classification_report
from tpumcia_torch.utils.split import train_test_split_indices


@dataclass
class CNNPipelineResult:
    head: CNNHead
    test_accuracy: float
    report: str
    occlusion: ChannelImportanceResult
    permutation: ChannelImportanceResult
    train_idx: np.ndarray
    test_idx: np.ndarray
    timings: dict = field(default_factory=dict)

    def summary(self) -> str:
        return "\n".join(
            [
                f"test accuracy: {self.test_accuracy:.4f}",
                self.occlusion.summary(),
                self.permutation.summary(),
            ]
        )


def _to_channel_result(drops: np.ndarray, method: str) -> ChannelImportanceResult:
    drops = np.atleast_2d(drops.T).T  # (C, R?)
    mean = drops.mean(axis=1)
    return ChannelImportanceResult(
        per_channel=[drops[c] for c in range(len(drops))],
        mean=mean,
        total=mean,
        ranking=np.argsort(mean)[::-1],
        feature_importances=np.zeros(0),
        feature_names=[],
        method=method,
    )


def _now(devices) -> float:
    for device in devices:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    return time.perf_counter()


def run_cnn_pipeline(
    images,
    labels,
    *,
    device="cuda",
    config: CNNConfig | None = None,
    mesh=None,
    test_size: float = 0.25,
    split_seed: int = 0,
    n_repeats: int = 5,
    importance_seed: int = 42,
    groups: np.ndarray | None = None,
    verbose: bool = False,
) -> CNNPipelineResult:
    """images: (B, H, W, C) integer levels (uint8: scaled by 255) or float
    in [0, 1], numpy or a tensor; they cross to ``device`` once and stay
    there. ``timings`` are wall seconds with the devices synchronised. With
    ``mesh``, ``device`` gives way to its first local slot's device."""
    if mesh is None:
        device = torch.device(require_device(device, "run_cnn_pipeline"))
        devices = [device]
    else:
        device = check_mesh(mesh).first_device
        devices = list(dict.fromkeys(mesh.slots[s][1] for s in mesh.local_slots()))
    if getattr(images, "ndim", np.ndim(images)) != 4:
        raise ValueError(
            f"run_cnn_pipeline expects (B, H, W, C) images; got shape {tuple(np.shape(images))}")
    x = images_on_device(images, device, int_max=None)  # integer levels over their dtype's maximum
    labels = np.asarray(labels)

    split = train_test_split_indices(
        len(x), test_size=test_size, seed=split_seed,
        stratify=labels if groups is None else None, groups=groups,
    )
    train = torch.from_numpy(np.asarray(split.train_idx)).to(device)
    test = torch.from_numpy(np.asarray(split.test_idx)).to(device)
    timings = {}
    t0 = _now(devices)
    cfg = config or CNNConfig(num_classes=len(np.unique(labels)))
    head = fit_cnn(
        x[train], labels[split.train_idx], device=device, config=cfg, mesh=mesh, verbose=verbose,
    )
    timings["fit_s"] = _now(devices) - t0

    x_test, y_test = x[test], labels[split.test_idx]
    pred = head.predict(x_test)
    test_acc = accuracy(y_test, pred)
    report = classification_report(y_test, pred)

    t0 = _now(devices)
    occ = channel_occlusion_importance(head, x_test, y_test)
    perm = channel_permutation_importance_images(
        head, x_test, y_test, n_repeats=n_repeats, seed=importance_seed
    )
    timings["importance_s"] = _now(devices) - t0

    return CNNPipelineResult(
        head=head,
        test_accuracy=test_acc,
        report=report,
        occlusion=_to_channel_result(occ[:, None], "occlusion"),
        permutation=_to_channel_result(perm, "image_permutation"),
        train_idx=split.train_idx,
        test_idx=split.test_idx,
        timings=timings,
    )
