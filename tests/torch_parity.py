"""Shared helpers of the tpumcia_torch parity tests (tests/test_torch_*.py).

Importing it limits torch to one thread: the suite runs several pytest
workers side by side on one host. Inputs are made with numpy from a seed;
where the JAX package draws random numbers (threefry, which torch cannot
reproduce), these helpers replay its draws so both packages see the same
numbers.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def to_chw_tensor(images_bhwc: np.ndarray) -> torch.Tensor:
    """(B, H, W, C) levels -> contiguous (B, C, H, W) int32 CPU tensor."""
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(images_bhwc).transpose(0, 3, 1, 2))
    ).to(torch.int32)


def jax_permutations(seed: int, num_draws: int, n: int) -> np.ndarray:
    """The rows tpumcia's ``_perm_sweep`` permutes by:
    ``split(key(seed), num_draws)`` then ``permutation(k, n)`` per key
    (permutation.py:174-181)."""
    import jax

    keys = jax.random.split(jax.random.key(seed), num_draws)
    return np.array(jax.vmap(lambda k: jax.random.permutation(k, n))(keys))


def jax_image_permutations(seed: int, num_channels: int, n_repeats: int, n: int) -> np.ndarray:
    """The (C, R, B) batch permutations of tpumcia's
    ``channel_permutation_importance_images``: ``split(key(seed), C * R)``
    reshaped (C, R), then ``permutation(k, B)`` per key
    (occlusion.py:109-116)."""
    return jax_permutations(seed, num_channels * n_repeats, n).reshape(num_channels, n_repeats, n)


def jax_init_weights(seed: int, num_features: int, num_classes: int) -> np.ndarray:
    """tpumcia's head init, ``0.01 * normal(key(seed), (F, k))``."""
    import jax
    import jax.numpy as jnp

    return np.array(
        jax.random.normal(jax.random.key(seed), (num_features, num_classes), jnp.float32)
        * 0.01
    )


def jax_mlp_init(seed: int, dims) -> dict:
    """tpumcia's MLP head init (heads.py:311-322) as numpy: one key per
    layer from ``split(key(seed), len(dims) - 1)``, He-normal weights
    ``normal(k, (d_in, d_out)) * sqrt(2 / d_in)``, zero biases, in the
    ``{"hidden": (...), "out": ...}`` layout."""
    import jax
    import jax.numpy as jnp

    keys = jax.random.split(jax.random.key(seed), len(dims) - 1)
    layers = [
        {"w": np.array(jax.random.normal(k, (d_in, d_out), jnp.float32) * jnp.sqrt(2.0 / d_in)),
         "b": np.zeros((d_out,), np.float32)}
        for k, d_in, d_out in zip(keys, dims[:-1], dims[1:])
    ]
    return {"hidden": tuple(layers[:-1]), "out": layers[-1]}


def replay_jax_draws(monkeypatch):
    """Hand the port tpumcia's own draws: the logistic and MLP heads' init
    and the permutation sweeps' rows, on every path that draws them."""
    from tpumcia_torch.importance import permutation
    from tpumcia_torch.models import fused, heads

    def weights(f, k, *, seed, device):
        return torch.from_numpy(jax_init_weights(seed, f, k)).to(device)

    def mlp(dims, *, seed, device):
        def layer(l):
            return {"w": torch.from_numpy(l["w"]).to(device), "b": torch.from_numpy(l["b"]).to(device)}

        p = jax_mlp_init(seed, list(dims))
        return {"hidden": tuple(layer(l) for l in p["hidden"]), "out": layer(p["out"])}

    def perms(num_draws, n, *, seed, device):
        return torch.from_numpy(jax_permutations(seed, num_draws, n)).long().to(device)

    for mod in (fused, heads):
        monkeypatch.setattr(mod, "init_weights", weights)
    monkeypatch.setattr(heads, "init_mlp_params", mlp)
    for mod in (fused, permutation):
        monkeypatch.setattr(mod, "draw_permutations", perms)


def cytometry_objects(n: int, hw: int = 48, channels: int = 12, signal_ch: int = 4, seed: int = 0):
    """Imaging-flow-cytometry-like objects (BASELINE config 4), shaped like
    examples/cytometry_h5.py and scaled to ``hw``: uint16 (n, hw, hw,
    channels) stacks with background U[200, 1500), a cell disk of radius
    U(10, 16)*hw/48 centred in [0.35, 0.65]*hw, and signal on ``signal_ch``
    only (activated: exp(-r/(8*hw/48))*38000, resting: disk*6000). Returns
    (images, shared (n, hw, hw) disk mask, labels (i // 8) % 2 with 0 =
    activated, donors "donor{i % 8}"): every donor holds both classes, so a
    donor-grouped test set does too. Vectorised numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    scale = hw / 48.0
    img = rng.integers(200, 1500, size=(n, hw, hw, channels)).astype(np.uint16)
    cy, cx = rng.uniform(hw * 0.35, hw * 0.65, size=(2, n, 1, 1))
    yy, xx = np.mgrid[:hw, :hw]
    r = np.hypot(yy[None] - cy, xx[None] - cx)
    cell = r < rng.uniform(10, 16, size=(n, 1, 1)) * scale
    labels = (np.arange(n) // 8) % 2
    boost = np.where(
        labels[:, None, None] == 0, np.exp(-r / (8 * scale)) * 38000, cell * 6000.0
    ).astype(np.uint16)
    img[..., signal_ch] = np.clip(
        img[..., signal_ch].astype(np.int64) + boost, 0, 65535
    ).astype(np.uint16)
    donors = np.array([f"donor{i % 8}" for i in range(n)])
    return img, cell, labels, donors


def require_cuda():
    """Skip the calling test unless a CUDA device is present (decided at run
    time, never at import, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; runs on the GPU with `python -m pytest -m cuda`")
    return torch.device("cuda", 0)


def random_tree(rng, *, splits: int, features: int, classes: int, pure: bool, chain: bool = False):
    """A tree in sklearn's ``tree_`` layout (read by duck typing) with
    ``splits`` internal nodes: each split turns a leaf into an internal node
    on a random feature and N(0, 1) threshold, its children appended after
    it. ``chain`` splits the newest leaf, a right child, each time (depth =
    splits) at thresholds near -2.5, so most N(0, 1) rows walk to the
    bottom; else a random leaf. Leaf fractions are one-hot (``pure``) or
    random."""
    feature, threshold, left, right, depth = [-2], [-2.0], [-1], [-1], [0]
    leaves = [0]
    for _ in range(splits):
        node = leaves.pop(-1 if chain else int(rng.integers(len(leaves))))
        feature[node] = int(rng.integers(features))
        threshold[node] = float(rng.normal(-2.5, 0.5) if chain else rng.normal())
        for side in (left, right):
            side[node] = len(feature)
            leaves.append(len(feature))
            feature.append(-2)
            threshold.append(-2.0)
            left.append(-1)
            right.append(-1)
            depth.append(depth[node] + 1)
    n = len(feature)
    if pure:
        value = np.eye(classes)[rng.integers(classes, size=n)]
    else:
        value = rng.random((n, classes)) + 0.05
        value /= value.sum(axis=1, keepdims=True)
    return SimpleNamespace(
        feature=np.array(feature, np.int64), threshold=np.array(threshold),
        children_left=np.array(left, np.int64), children_right=np.array(right, np.int64),
        value=value[:, None, :], max_depth=max(depth),
    )


# the walk kernel's cases: name -> (classes, pure leaves, grouped masks, what
# else the forest or the rows hold)
WALK_CASES = {
    "pure_k6_per_feature": (6, True, False, None),
    "impure_k6_grouped": (6, False, True, None),
    "pure_k2_grouped": (2, True, True, None),
    "impure_k2_per_feature": (2, False, False, None),
    "impure_k12_grouped": (12, False, True, None),
    "impure_k33_grouped": (33, False, True, None),  # two of the kernel's 32-class tiles
    "root_only_tree": (3, True, False, "root_only"),
    "nan_feature": (6, True, False, "nan"),
    "deeper_than_19": (6, False, True, "chain"),
}
WALK_ROWS, WALK_FEATURES, WALK_REPEATS = 40, 7, 2


def walk_case(case: str):
    """(trees, X (WALK_ROWS, WALK_FEATURES) f32 CPU tensor, (G, F) f32 masks)
    of a :data:`WALK_CASES` case: 9 random trees of 1-29 splits; a root-only
    tree among them, a chain of 25 splits, or NaN in every third row of
    feature 2; per-feature masks (the identity) or four column groups."""
    classes, pure, grouped, extra = WALK_CASES[case]
    rng = np.random.default_rng(sorted(WALK_CASES).index(case))
    trees = [random_tree(rng, splits=int(rng.integers(1, 30)), features=WALK_FEATURES,
                         classes=classes, pure=pure) for _ in range(9)]
    if extra == "root_only":
        trees[3] = random_tree(rng, splits=0, features=WALK_FEATURES, classes=classes, pure=pure)
    if extra == "chain":
        trees[5] = random_tree(rng, splits=25, features=WALK_FEATURES, classes=classes, pure=pure,
                               chain=True)
    X = rng.normal(size=(WALK_ROWS, WALK_FEATURES)).astype(np.float32)
    if extra == "nan":
        X[::3, 2] = np.nan
    masks = np.eye(WALK_FEATURES, dtype=np.float32)
    if grouped:
        masks = np.zeros((4, WALK_FEATURES), np.float32)
        for g, cols in enumerate([[0, 3], [1, 2, 6], [4], [5]]):
            masks[g, cols] = 1.0
    return trees, torch.from_numpy(X), torch.from_numpy(masks)
