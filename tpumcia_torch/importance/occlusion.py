"""Occlusion and pixel-space channel importance for the CNN path
(counterpart of ``tpumcia.importance.occlusion``, BASELINE config 3).

Three probes over a trained image classifier (``models.train.CNNHead``):

* :func:`channel_occlusion_importance`: replace one channel by ``fill``;
  the accuracy drop is that channel's importance, (C,);
* :func:`channel_permutation_importance_images`: shuffle one channel's
  planes across the batch (the channel keeps its marginal distribution and
  loses its alignment with the labels), ``n_repeats`` fresh permutations a
  channel, (C, R);
* :func:`occlusion_map`: slide a ``window`` x ``window`` patch of ``fill``
  over the image; the drop of the true class's probability per position is a
  saliency map, (B, rows, cols).

All run without gradients on the head's device, a chunk of the batch at a
time: an altered copy exists for one chunk only, so a sweep over C channels
x R repeats never holds C*R copies of the images. Over a head's mesh
(``CNNHead.mesh``) each data slot takes its rows of every altered batch on
its device's replica (the alteration, a permutation of the whole batch
included, is applied before the split); the integer counts of correct
predictions are summed over the slots and ranks, and ``occlusion_map``'s
per-image drops are gathered in row order, so every rank gets the result.
Accuracies are float32 and rounded as tpumcia's (the count times the
float32 reciprocal of B), so equal predictions give equal drops. A
label that training never saw maps to -1 (``labels_to_class_idx``): in the
accuracy probes it counts as a misprediction; in :func:`occlusion_map` it
reads the last class in both the base and the occluded probabilities.
"""

from __future__ import annotations

import numpy as np
import torch

from tpumcia_torch.features.stats import on_device
from tpumcia_torch.importance.permutation import (
    check_n_repeats,
    draw_permutations,
    labels_to_class_idx,
)
from tpumcia_torch.models.train import PREDICT_CHUNK


def _inputs(head, images, y):
    """float32 (B, H, W, C) images and int64 class indices on the head's
    device."""
    dev = head.device
    x = on_device(images, dev).to(torch.float32)
    if x.dim() != 4:
        raise ValueError(f"expected (B, H, W, C) images; got shape {tuple(x.shape)}")
    y_idx = torch.from_numpy(labels_to_class_idx(y, head.classes).astype(np.int64)).to(dev)
    return x, y_idx


def _accuracy(head, x, y_idx, alter=None) -> torch.Tensor:
    """float32 accuracy of ``head`` on ``x``, or on ``alter(x[s:e], s, e)``
    chunk by chunk (``alter`` gets a copy it may write into)."""
    correct = torch.zeros((), dtype=torch.int64, device=x.device)
    for model, dev, s, e in head.chunks(len(x), PREDICT_CHUNK):
        xc = x[s:e] if alter is None else alter(x[s:e].clone(), s, e)
        pred = torch.argmax(head.forward(xc.to(dev), model), dim=-1).to(x.device)
        correct += (pred == y_idx[s:e]).sum()
    correct = head.sum_over_ranks(correct)
    # jnp.mean's rounding: the count times the float32 reciprocal of B
    return correct.to(torch.float32) * float(np.float32(1.0) / np.float32(len(x)))


def channel_occlusion_importance(head, images, y, *, fill: float = 0.0) -> np.ndarray:
    """(C,) accuracy drops when each channel is replaced by ``fill``."""
    x, y_idx = _inputs(head, images, y)
    baseline = _accuracy(head, x, y_idx)

    def occluded(c):
        def alter(xc, s, e):
            xc[..., c] = fill
            return xc
        return _accuracy(head, x, y_idx, alter)

    drops = baseline - torch.stack([occluded(c) for c in range(x.shape[-1])])
    return drops.cpu().numpy().astype(np.float64)


def channel_permutation_importance_images(
    head, images, y, *, n_repeats: int = 5, seed: int = 42, _perms=None
) -> np.ndarray:
    """(C, R) accuracy drops when channel c's planes are shuffled across the
    batch (each repeat a fresh permutation, drawn by
    ``permutation.draw_permutations`` from ``seed``). ``_perms``: (C, R, B)
    ready-made permutations instead (the tests replay tpumcia's)."""
    R = check_n_repeats(n_repeats)
    x, y_idx = _inputs(head, images, y)
    B, C = x.shape[0], x.shape[-1]
    if _perms is None:
        perms = draw_permutations(C * R, B, seed=seed, device=x.device).reshape(C, R, B)
    else:
        perms = torch.as_tensor(np.asarray(_perms), dtype=torch.int64, device=x.device)
        if tuple(perms.shape) != (C, R, B):
            raise ValueError(f"_perms must have shape {(C, R, B)}; got {tuple(perms.shape)}")
    baseline = _accuracy(head, x, y_idx)

    def shuffled(c, perm):
        plane = x[..., c]  # (B, H, W) view

        def alter(xc, s, e):
            xc[..., c] = plane[perm[s:e]]
            return xc
        return _accuracy(head, x, y_idx, alter)

    scores = torch.stack([
        torch.stack([shuffled(c, perms[c, r]) for r in range(R)]) for c in range(C)
    ])
    return (baseline - scores).cpu().numpy().astype(np.float64)


def occlusion_map(
    head, images, y, *, window: int = 8, stride: int = 8, fill: float = 0.0
) -> np.ndarray:
    """(B, R, C) map of true-class probability drops when a ``window`` x
    ``window`` patch (all channels) is filled at each grid position, where
    R = len(range(0, H-window+1, stride)) (min 1) and likewise C over W:
    windows are kept fully inside the image, so for window > stride the grid
    is smaller than ceil(H/stride)."""
    x, y_idx = _inputs(head, images, y)
    B, H, W, _ = x.shape
    rows = list(range(0, H - window + 1, stride)) or [0]
    cols = list(range(0, W - window + 1, stride)) or [0]

    def true_class_prob(alter):
        """(this process's rows,) true-class probabilities."""
        out = [torch.zeros((0,), device=x.device)]
        for model, dev, s, e in head.chunks(B, PREDICT_CHUNK):
            xc = x[s:e]
            p = torch.softmax(head.forward((xc if alter is None else alter(xc.clone())).to(dev), model), dim=-1)
            out.append(torch.take_along_dim(p.to(x.device), y_idx[s:e, None] % p.shape[1], dim=1)[:, 0])
        return torch.cat(out)

    base = true_class_prob(None)
    drops = []
    for r in rows:
        for c in cols:
            def alter(xc, r=r, c=c):
                xc[:, r:r + window, c:c + window, :] = fill
                return xc
            drops.append(base - true_class_prob(alter))
    drops = head.gather_rows([torch.stack(drops, dim=1)])  # every rank's rows, in order
    return drops.reshape(B, len(rows), len(cols)).cpu().numpy()
