"""The feature path over a device mesh (counterpart of
``tpumcia.parallel.sharding``).

Where tpumcia's ``shard_map`` runs the Pallas kernel once per device on
that device's block of the batch, each data slot here runs
``cuda_glcm.sufficient_stats(_multi)`` on its rows on its device: one
kernel launch a slot on a CUDA device, the plain version on the CPU. Rows
are split as tpumcia splits them (:func:`parallel.mesh.row_ranges`, no pad
rows). The per-slot results are joined in row order on the first slot's
device, then gathered over the ranks of the mesh's process group, so every
rank ends with the whole result, as a replicated fetch gives it in tpumcia.

* :func:`sufficient_stats_sharded` / :func:`sufficient_stats_sharded_multi`
  and :func:`extract_features_sharded`: objects over the data axis; each
  object's statistics do not depend on its batch, so the sharded result is
  the unsharded one bit for bit;
* :func:`fit_scaler_sharded`: per-slot min/max, combined locally, then by a
  MIN/MAX all-reduce over the ranks;
* :func:`permutation_importance_sharded`: the (group, repeat) sweep with the
  groups over the data axis; the permutations are drawn once from the seed,
  as the unsharded sweep draws them, so the result is the unsharded one for
  the same seed whatever the slot count.

Every input may be a host array that is identical on every rank, a tensor,
or a :class:`parallel.distributed.ShardedRows` (this rank's rows of a batch
spread over the ranks, split over its own slots).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from tpumcia_torch.features.stats import SuffStats
from tpumcia_torch.parallel.distributed import ShardedRows, all_gather_rows, all_reduce_max, all_reduce_min
from tpumcia_torch.parallel.mesh import Mesh, Sharding, replicated, row_ranges, split_rows

# the fields one multi-offset pass shares across its offsets
_SHARED = ("hist", "count", "vmax")


def _local_blocks(x, mesh: Mesh) -> list[tuple[int, object]]:
    """(data index, rows) for each of this process's slots: its slots' row
    ranges of a whole batch, or a :class:`ShardedRows` block split over
    them."""
    local = mesh.local_slots()
    if isinstance(x, ShardedRows):
        parts = split_rows(len(x.rows), len(local))
        return [(s, x.rows[a:b]) for s, (a, b) in zip(local, parts)]
    ranges = row_ranges(len(x), mesh)
    return [(s, x[ranges[s][0]:ranges[s][1]]) for s in local]


def _gather_rows(parts: list[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """This process's per-slot row blocks, joined in order on its first
    slot's device, then every rank's, in rank order."""
    first = mesh.first_device
    return all_gather_rows(torch.cat([p.to(first) for p in parts]), mesh.group)


def _rows_of(x):
    return x.rows if isinstance(x, ShardedRows) else x


def _as_sharding(sharding) -> Sharding:
    """A :class:`Sharding`, or a :class:`Mesh` as its replicated placement."""
    if isinstance(sharding, Mesh):
        return replicated(sharding)
    if not isinstance(sharding, Sharding):
        raise TypeError(
            "sharding must be parallel.data_sharding(mesh), parallel.replicated(mesh) "
            f"or a Mesh; got {type(sharding).__name__}"
        )
    return sharding


def local_to_global(arr, sharding):
    """``arr``, which every process holds whole, placed by ``sharding``:
    under ``data_sharding`` the rows of this process's slots as a
    :class:`ShardedRows`, under ``replicated`` (or a Mesh) ``arr`` as it
    is."""
    sh = _as_sharding(sharding)
    if sh.spec != ("data",):
        return arr
    ranges = row_ranges(len(arr), sh.mesh)
    local = sh.mesh.local_slots()
    a, b = ranges[local[0]][0], ranges[local[-1]][1]
    return ShardedRows(arr[a:b], a, len(arr))


def place_global(arr, sharding):
    """``arr`` placed by ``sharding`` (``data_sharding`` or ``replicated``
    of a mesh, or a Mesh for ``replicated``): a :class:`ShardedRows` stays
    as it is under ``data_sharding`` and is gathered whole over the mesh's
    ranks under ``replicated`` (a tensor on the first slot's device);
    anything else is a batch every process holds whole
    (:func:`local_to_global`)."""
    sh = _as_sharding(sharding)
    if not isinstance(arr, ShardedRows):
        return local_to_global(arr, sh)
    if sh.spec == ("data",):
        return arr
    rows = arr.rows if isinstance(arr.rows, torch.Tensor) else torch.from_numpy(np.asarray(arr.rows))
    return _gather_rows([rows], sh.mesh)


def _stats_over_mesh(images, mask, mesh, *, levels, offsets, use_pallas, need_diff,
                     with_intensity=True, with_glcm=True):
    from tpumcia_torch.config import FeatureConfig
    from tpumcia_torch.features import cuda_glcm
    from tpumcia_torch.features.extract import _as_level_array, _chw_levels, _to_device, check_use_pallas
    from tpumcia_torch.features.stats import check_mask_shape, disable_fields, prepare_mask

    pallas = FeatureConfig(use_pallas=use_pallas)
    rows = _as_level_array(_rows_of(images), levels)
    if rows.ndim != 4:
        raise ValueError(f"expected (B, H, W, C) images; got shape {tuple(rows.shape)}")
    if mask is not None:
        check_mask_shape(_rows_of(mask), rows.shape)
    images = dataclasses.replace(images, rows=rows) if isinstance(images, ShardedRows) else rows
    mask_blocks = None if mask is None else _local_blocks(mask, mesh)
    per_slot = []
    for i, (s, block) in enumerate(_local_blocks(images, mesh)):
        dev = mesh.slots[s][1]
        check_use_pallas(pallas, dev)
        m = None if mask is None else prepare_mask(mask_blocks[i][1], block.shape, dev)
        per_slot.append([disable_fields(st, with_intensity=with_intensity, with_glcm=with_glcm)
                         for st in cuda_glcm.sufficient_stats_multi(
                             _chw_levels(_to_device(block, dev)), m, levels=levels,
                             offsets=offsets, need_diff=need_diff)])
    out = []
    for o in range(len(offsets)):
        fields = {}
        for name in SuffStats._fields:
            if o and name in _SHARED:
                fields[name] = getattr(out[0], name)
                continue
            parts = [getattr(st[o], name) for st in per_slot]
            fields[name] = None if parts[0] is None else _gather_rows(parts, mesh)
        out.append(SuffStats(**fields))
    return tuple(out)


def sufficient_stats_sharded(
    images,
    mask=None,
    *,
    mesh: Mesh,
    levels: int = 256,
    offset: tuple[int, int] = (0, 5),
    chunk_size: int = 32,
    onehot_dtype: str = "bfloat16",
    use_pallas: str = "auto",
    with_intensity: bool = True,
    with_glcm: bool = True,
    need_diff_hist: bool = True,
) -> SuffStats:
    """Per-(image, channel) sufficient statistics with the batch over the
    mesh's data axis: (B, H, W, C) levels and an optional (B, H, W[, C])
    mask -> the whole batch's :class:`SuffStats` on this process's first
    slot's device. ``need_diff_hist=False`` selects the ``dstats`` contract
    (below the B1d sizes), as on one device. ``with_intensity`` /
    ``with_glcm`` zero the fields they turn off in each slot's result, as
    ``features.stats.sufficient_stats`` does; ``chunk_size`` and
    ``onehot_dtype`` (tpumcia's XLA memory knobs) are ignored."""
    return _stats_over_mesh(
        images, mask, mesh, levels=levels, offsets=[tuple(offset) if with_glcm else (0, 0)],
        use_pallas=use_pallas, need_diff=need_diff_hist,
        with_intensity=with_intensity, with_glcm=with_glcm,
    )[0]


def sufficient_stats_sharded_multi(
    images,
    mask=None,
    *,
    mesh: Mesh,
    levels: int = 256,
    offsets: tuple[tuple[int, int], ...] = ((0, 5),),
    chunk_size: int = 32,
    onehot_dtype: str = "bfloat16",
    use_pallas: str = "auto",
    with_intensity: bool = True,
    need_diff_hist: bool = True,
) -> tuple[SuffStats, ...]:
    """:func:`sufficient_stats_sharded` for several offsets in one pass a
    slot (kernel form B2), one :class:`SuffStats` per offset."""
    return _stats_over_mesh(
        images, mask, mesh, levels=levels, offsets=[tuple(o) for o in offsets],
        use_pallas=use_pallas, need_diff=need_diff_hist, with_intensity=with_intensity,
    )


def extract_features_sharded(
    images,
    mask=None,
    *,
    mesh: Mesh,
    levels: int = 256,
    offset: tuple[int, int] = (0, 5),
    chunk_size: int = 32,
    precision: str = "exact",
    channel_names: list[str] | None = None,
):
    """The 23-per-channel features of one offset with the statistics over
    the mesh (tpumcia's ``extract_features_sharded``); ``extract_features``
    with ``mesh=`` takes every other config. ``chunk_size`` (an XLA memory
    knob of tpumcia's) is ignored."""
    from tpumcia_torch.features import registry
    from tpumcia_torch.features.extract import FeatureMatrix
    from tpumcia_torch.features.finalize import finalize_features

    stats = sufficient_stats_sharded(images, mask, mesh=mesh, levels=levels, offset=offset)
    backend = {"exact": "host", "hybrid": "hybrid", "device": "device"}[precision]
    shape = _rows_of(images).shape
    if backend == "hybrid" and shape[1] * shape[2] >= 65536:
        backend = "host"
    done = finalize_features(stats, backend=backend)
    C = shape[-1]
    return FeatureMatrix(
        values=done.values,
        names=registry.feature_names(C, channel_names=channel_names),
        num_channels=C,
        degenerate=done.degenerate if isinstance(done.degenerate, np.ndarray)
        else done.degenerate.cpu().numpy(),
    )


def fit_scaler_sharded(X, *, mesh: Mesh):
    """Global per-feature min/max (NaNs ignored, as ``MinMaxScaler.fit``
    ignores them) over the mesh: each slot reduces its rows, the slots are
    combined on the first slot's device and the ranks by an all-reduce. The
    scaler lives on the first slot's device."""
    from tpumcia_torch.models.scaler import MinMaxScaler

    first = mesh.first_device
    F = _rows_of(X).shape[1]
    lo = torch.full((F,), torch.inf, device=first)
    hi = torch.full((F,), -torch.inf, device=first)
    for s, rows in _local_blocks(X, mesh):
        if len(rows):
            part = MinMaxScaler.fit(torch.as_tensor(rows, dtype=torch.float32, device=mesh.slots[s][1]))
            lo = torch.minimum(lo, part.data_min.to(first))
            hi = torch.maximum(hi, part.data_max.to(first))
    return MinMaxScaler(all_reduce_min(lo, mesh.group), all_reduce_max(hi, mesh.group))


def _on_device(obj, device):
    """A head's scoring state (tensors, dicts, tuples, dataclasses such as
    ``DeviceForest``, a ``functools.partial``) with every tensor on
    ``device``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, functools.partial):
        return functools.partial(obj.func, *(_on_device(a, device) for a in obj.args))
    if isinstance(obj, dict):
        return {k: _on_device(v, device) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(_on_device(v, device) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _on_device(getattr(obj, f.name), device) for f in dataclasses.fields(obj)
        })
    return obj


def permutation_importance_sharded(
    head,
    X,
    y,
    *,
    mesh: Mesh,
    n_repeats: int = 10,
    seed: int = 42,
    groups: list[list[int]] | None = None,
):
    """The device permutation sweep with its groups over the mesh's data
    axis: X, the labels and the head are copied to every slot's device, the
    (G, R, N) permutations are drawn once on the first slot's device as
    ``permutation_importance`` draws them, each slot scores its groups'
    draws, and the drops are gathered in group order."""
    from tpumcia_torch.importance.permutation import (
        PermutationResult,
        _device_score_parts,
        _perm_sweep,
        check_n_repeats,
        draw_permutations,
        group_masks,
        labels_to_class_idx,
    )

    R = check_n_repeats(n_repeats)
    apply_fn, classes = _device_score_parts(head)
    X = place_global(X, mesh)
    y_idx = labels_to_class_idx(y, classes)
    N, F = X.shape
    masks = group_masks(groups, F)
    G = masks.shape[0]
    first = mesh.first_device
    perms = draw_permutations(G * R, N, seed=seed, device=first).reshape(G, R, N)
    ranges = row_ranges(G, mesh)
    parts, baseline = [], None
    with torch.no_grad():
        for s in mesh.local_slots():
            a, b = ranges[s]
            dev = mesh.slots[s][1]
            base, drops = _perm_sweep(
                torch.as_tensor(X, dtype=torch.float32, device=dev),
                torch.as_tensor(y_idx, dtype=torch.int64, device=dev),
                torch.as_tensor(masks[a:b], device=dev), perms[a:b].to(dev),
                _on_device(apply_fn, dev),
            )
            baseline = float(base) if baseline is None else baseline
            parts.append(drops)
    imp = _gather_rows(parts, mesh).cpu().numpy().astype(np.float64)
    return PermutationResult(
        importances=imp,
        importances_mean=imp.mean(axis=1),
        importances_std=imp.std(axis=1),
        baseline_score=baseline,
    )
