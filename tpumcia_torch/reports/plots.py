"""Plotting utilities reproducing the reference's three figures (a copy of
``tpumcia.reports.plots``: numpy and matplotlib only, and matplotlib is
imported inside the functions, so the package imports without it):

* top-k feature-importance horizontal bar (notebook cell 23)
* per-channel importance boxplot (cell 26)
* permutation-importance boxplot (cell 28)

Reference quirks handled explicitly:
* cell 23/28 slice ``argsort(...)[-20:-1]`` — ranks 2..20, silently dropping
  the single most important feature (ipynb:436, 497). Default here includes
  the top feature; ``compat_drop_top=True`` replicates the quirk.
* cell 28 labels the permutation boxplot with the *MDI* ordering (label/data
  mismatch, ipynb:500-501 vs :436). Here labels always match the data.
"""

from __future__ import annotations

import numpy as np


def _axes(ax):
    if ax is not None:
        return ax, ax.figure
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 6))
    return ax, fig


def plot_top_features(
    importances,
    names,
    *,
    top_k: int = 20,
    compat_drop_top: bool = False,
    ax=None,
    title: str = "Feature importances",
):
    """Horizontal bar chart of the top-k features (cell 23 layout)."""
    importances = np.asarray(importances)
    order = np.argsort(importances)
    sel = order[-top_k:-1] if compat_drop_top else order[-top_k:]
    ax, fig = _axes(ax)
    ax.barh(range(len(sel)), importances[sel], align="center")
    ax.set_yticks(range(len(sel)))
    ax.set_yticklabels([names[i] for i in sel])
    ax.set_xlabel("importance")
    ax.set_title(title)
    fig.tight_layout()
    return fig


def plot_channel_importance(result, *, ax=None, title: str = "Channel importance"):
    """Boxplot of the per-channel importance distributions (cell 26 layout).
    ``result``: a ChannelImportanceResult."""
    ax, fig = _axes(ax)
    data = [
        v if len(v) else np.zeros(1) for v in result.per_channel
    ]
    ax.boxplot(data, tick_labels=[result.channel_label(c) for c in range(len(data))])
    ax.set_ylabel(f"importance ({result.method})")
    ax.set_title(title)
    fig.tight_layout()
    return fig


def plot_permutation_importance(
    perm_result,
    names,
    *,
    top_k: int = 20,
    compat_drop_top: bool = False,
    ax=None,
    title: str = "Permutation importances (test set)",
):
    """Boxplot over repeats for the top-k features by mean importance
    (cell 28 layout, with labels matching the plotted data — the reference's
    label/data mismatch is not replicated)."""
    imp = np.asarray(perm_result.importances)  # (F, R)
    order = np.argsort(perm_result.importances_mean)
    sel = order[-top_k:-1] if compat_drop_top else order[-top_k:]
    ax, fig = _axes(ax)
    ax.boxplot(
        imp[sel].T,
        orientation="horizontal",
        tick_labels=[names[i] for i in sel],
    )
    ax.set_xlabel("accuracy drop")
    ax.set_title(title)
    fig.tight_layout()
    return fig


def plot_sample_grid(images, labels=None, class_names=None, *, n: int = 9, seed: int = 0):
    """3x3 random sample grid, gray colormap, vmin/vmax 0..255 (cell 7)."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    rng = np.random.default_rng(seed)
    images = np.asarray(images)
    idx = rng.choice(len(images), size=min(n, len(images)), replace=False)
    side = int(np.ceil(np.sqrt(len(idx))))
    fig, axes = plt.subplots(side, side, figsize=(6, 6))
    for ax, i in zip(np.ravel(axes), idx):
        img = images[i]
        if img.ndim == 3:
            img = img[..., 0]
        ax.imshow(img, cmap="gray", vmin=0, vmax=255)
        if labels is not None:
            name = class_names[labels[i]] if class_names else str(labels[i])
            ax.set_title(name, fontsize=8)
        ax.axis("off")
    for ax in np.ravel(axes)[len(idx):]:
        ax.axis("off")
    fig.tight_layout()
    return fig


def plot_occlusion_maps(images, maps, *, n: int = 6, alpha: float = 0.6):
    """Overlay CNN occlusion saliency maps (``importance.occlusion.occlusion_map``)
    on their images: each panel shows the (grayscale) image with the
    upsampled probability-drop map blended on top. The CNN-path spatial
    companion to the channel-level importance figures."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    images = np.asarray(images)
    maps = np.asarray(maps)
    n = min(n, len(images))
    fig, axes = plt.subplots(1, n, figsize=(2.2 * n, 2.6))
    axes = np.atleast_1d(axes)
    vmax = max(float(np.max(np.abs(maps[:n]))), 1e-9)
    for ax, i in zip(axes, range(n)):
        img = images[i]
        if img.ndim == 3:
            img = img[..., 0]
        ax.imshow(img, cmap="gray")
        # nearest-neighbour upsample of the coarse occlusion grid
        m = maps[i]
        ry = int(np.ceil(img.shape[0] / m.shape[0]))
        rx = int(np.ceil(img.shape[1] / m.shape[1]))
        up = np.repeat(np.repeat(m, ry, axis=0), rx, axis=1)
        up = up[: img.shape[0], : img.shape[1]]
        ax.imshow(up, cmap="magma", alpha=alpha, vmin=0, vmax=vmax)
        ax.axis("off")
    fig.suptitle("Occlusion saliency (true-class probability drop)")
    fig.tight_layout()
    return fig
