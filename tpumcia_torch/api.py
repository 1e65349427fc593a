"""High-level workflow API mirroring the reference notebook (counterpart
of ``tpumcia.api``: "load h5 objects, extract features, train a classifier
head, report per-channel importance").

    objs = load_objects("objects/")                       # h5 contract (README.md)
    fm   = extract_features(levels, mask=..., device=dev)  # features/extract
    head = fit_head(fm, labels, device=dev)                # models/heads
    imp  = channel_importance(head, fm, labels)            # importance/channels

or in one call over an ObjectBatch: ``analyze_objects(objs, device=dev)``.
"""

from __future__ import annotations

import numpy as np


def load_objects(*args, **kwargs):
    from tpumcia_torch.io.h5 import load_objects as _impl

    return _impl(*args, **kwargs)


def fit_head(*args, **kwargs):
    from tpumcia_torch.models.heads import fit_head as _impl

    return _impl(*args, **kwargs)


def channel_importance(*args, **kwargs):
    from tpumcia_torch.importance.channels import channel_importance as _impl

    return _impl(*args, **kwargs)


def feature_importance(*args, **kwargs):
    from tpumcia_torch.importance.permutation import permutation_importance as _impl

    return _impl(*args, **kwargs)


def run_pipeline(*args, **kwargs):
    from tpumcia_torch.pipeline.run import run_pipeline as _impl

    return _impl(*args, **kwargs)


def analyze_objects(objects, *, device="cuda", config=None, labels=None):
    """Full analysis straight from an h5 :class:`ObjectBatch` on ``device``:
    quantise (16-bit aware, on the device) -> features (masked) ->
    split/fit/report -> channel importance. Labels default to the batch's
    ``label`` metadata. ``device`` may be a pool of devices, which
    ``run_pipeline`` resolves ``config.mesh`` against (16-bit data is then
    quantised on the pool's first device)."""
    import torch

    from tpumcia_torch.utils.device import require_device

    from tpumcia_torch.config import coerce_config
    from tpumcia_torch.parallel.mesh import device_pool
    from tpumcia_torch.pipeline.run import run_pipeline
    from tpumcia_torch.preprocess.normalize import quantize_to_levels

    require_device(device, "analyze_objects")
    cfg = coerce_config(config)
    labels = labels if labels is not None else objects.labels
    if labels is None:
        raise ValueError("objects carry no labels; pass labels= explicitly")
    images = np.asarray(objects.images)
    if images.dtype == np.uint16:
        first = device_pool(device)[0] if isinstance(device, (list, tuple)) else device
        levels = quantize_to_levels(
            torch.from_numpy(images).to(first),
            levels=cfg.features.glcm.levels, src_levels=65536,
        )
    elif images.dtype == np.uint8:
        levels = images
    else:
        raise TypeError(f"unsupported image dtype {images.dtype}")

    groups = None
    if cfg.split.group_by == "donor":
        groups = objects.donors
    elif cfg.split.group_by == "experiment":
        groups = objects.experiments

    return run_pipeline(
        levels,
        labels,
        device=device,
        mask=objects.masks,
        config=cfg,
        channel_names=objects.channels,
        groups=groups,
    )
