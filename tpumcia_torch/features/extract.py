"""Batched feature extraction: (N, H, W, C) level images (optionally
masked) -> (N, 23*C) features (the counterpart of
``tpumcia.features.extract``).

:func:`extract_features` runs every single-device form of tpumcia's entry:

- ``precision='hybrid'``, one offset: statistics -> u32 wire on the device,
  one copy to the host, float64 assembly (:func:`_batch_fused_dispatch`);
- ``'hybrid'`` with a GLCM offset list: the multi-offset kernel form and the
  multi-offset wire back to back on the device, one copy to the host;
- ``'exact'`` (difference histograms, float64 on the host, < 1e-9 against
  the notebook) and ``'device'`` (float32 on the device), one offset at a
  time or an offset list in one pass, and intensity-only or GLCM-only
  configs;
- at H*W >= 65536 or more than 256 levels (kernel forms B1d and, past 4096
  levels, B1e), tpumcia's routing: the statistics carry the difference histogram, ``'hybrid'``
  becomes the host backend at H*W >= 65536 and takes the packed f32 wire
  above 256 levels.

:func:`extract_features_pending` is the fused fast path of ``run_pipeline``:
fixed-size batches, each running (noise synthesis), the statistics kernel,
the wire and the f32 device feature block back to back, with the wires
copied to the host at the end. :func:`extract_features_batched` takes it
when the config allows and runs :func:`extract_features` per batch
otherwise.

With ``include_morphology`` (a mask is required) each channel's 8 mask
shape features come last; a shared (B, H, W) mask gives every channel its 8
values. With a device ``mesh`` (``parallel.mesh``) the statistics run
over its data slots, one launch a slot (``parallel.sharding``), and the
features are finalised from the whole batch's statistics. On a
CUDA device the kernel's bounds (32768 levels, tpumcia's own; 2^24 pixels)
raise a ``ValueError``; a CPU device takes every size. Above 256 levels the
statistics of one batch hold 5 L floats per (image, channel) and offset (4.0
GB for 2048 x 12 items at 8192 levels): size the batch to the level count.
The batched entry points hold one batch's statistics at a time.

A collection on the host crosses to a CUDA device one batch at a time
(``io.staging``: pinned buffers, a side stream), at most ``in_flight``
batches ahead of the device; a tensor already on the device is used as it
is.
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from tpumcia_torch.config import FeatureConfig
from tpumcia_torch.features import registry
from tpumcia_torch.utils.device import require_device
from tpumcia_torch.utils.profiling import stage


def _to_host(a):
    """A tensor (any device) or array-like -> numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


@dataclass
class FeatureMatrix:
    """Feature values plus column metadata."""

    values: Any  # (B, F) float64 np.ndarray, or a f32 tensor (precision='device')
    names: list[str]
    num_channels: int
    degenerate: Any = None  # (B, C) bool flags, numpy
    config: FeatureConfig = field(default_factory=FeatureConfig)
    channel_names: list[str] | None = None
    # the NaN-cleaned f32 copy of the matrix that stays on the device for
    # the head and the permutation sweeps
    device_values: Any = None

    @property
    def shape(self):
        return tuple(self.values.shape)

    def __len__(self):
        return self.values.shape[0]

    def column(self, name: str):
        return self.values[:, self.names.index(name)]

    def channel_columns(self) -> list[list[int]]:
        """Per-channel column groups from the positional block layout (one
        GLCM block per offset of the config)."""
        labels = self.config.glcm.pair_labels
        return registry.columns_by_channel_positional(
            self.num_channels,
            include_intensity=self.config.include_intensity,
            include_glcm=self.config.include_glcm,
            num_glcm_blocks=len(labels) if labels else 1,
            include_morphology=self.config.include_morphology,
        )

    def to_numpy(self) -> np.ndarray:
        return _to_host(self.values)

    def to_pandas(self):
        import pandas as pd

        return pd.DataFrame(self.to_numpy(), columns=self.names)

    def save(self, path) -> None:
        """Persist to .npz: values, names, flags, the config (so that a
        loaded multi-offset matrix groups its columns right) and channel
        names."""
        payload = dict(
            values=self.to_numpy(),
            names=np.array(self.names),
            num_channels=self.num_channels,
            degenerate=(
                _to_host(self.degenerate) if self.degenerate is not None
                else np.zeros((len(self), self.num_channels), bool)
            ),
            config_json=np.asarray(json.dumps(dataclasses.asdict(self.config))),
        )
        if self.channel_names is not None:
            payload["channel_names"] = np.array(self.channel_names)
        np.savez_compressed(path, **payload)

    @classmethod
    def load(cls, path) -> "FeatureMatrix":
        from tpumcia_torch.config import build_config

        with np.load(path, allow_pickle=False) as z:
            cfg = (
                build_config(FeatureConfig, json.loads(str(z["config_json"])))
                if "config_json" in z else FeatureConfig()
            )
            return cls(
                values=z["values"],
                names=[str(n) for n in z["names"]],
                num_channels=int(z["num_channels"]),
                degenerate=z["degenerate"],
                config=cfg,
                channel_names=(
                    [str(c) for c in z["channel_names"]]
                    if "channel_names" in z else None
                ),
            )


# the one statement of the eligibility rules for error messages — edit it
# together with hybrid_wire_ok below
FAST_PATH_REQS = (
    "(precision='hybrid', single GLCM offset, intensity+GLCM, no "
    "morphology, < 2^16 pixels/channel, levels <= 256)"
)


def hybrid_wire_ok(cfg: FeatureConfig, images_shape=None, *, multi_offset: bool = False) -> bool:
    """The u32-wire eligibility: hybrid precision, one GLCM offset (any
    number with ``multi_offset=True``, the multi-offset wire),
    intensity+GLCM, <= 256 levels and (when the shape is known) < 2^16
    pixels per channel, the wire's exact-integer bounds."""
    offsets = cfg.glcm.offsets if cfg.include_glcm else [cfg.glcm.offset]
    return (
        cfg.precision == "hybrid"
        and cfg.glcm.levels <= 256
        and cfg.include_intensity
        and cfg.include_glcm
        and (multi_offset or len(offsets) == 1)
        and (images_shape is None or images_shape[1] * images_shape[2] < 65536)
    )


def batched_fast_path_ok(images_shape, cfg: FeatureConfig) -> bool:
    """True when the fused batched hybrid wire path applies."""
    return hybrid_wire_ok(cfg, images_shape) and not cfg.include_morphology


def check_use_pallas(cfg: FeatureConfig, device: torch.device) -> None:
    """``use_pallas`` is kept so config files stay compatible. On a CUDA
    device the kernel always runs, so ``'never'`` (which asked for the plain
    version) is refused rather than silently ignored."""
    if device.type == "cuda" and cfg.use_pallas == "never":
        raise ValueError(
            "features.use_pallas='never' asks for the plain version, but on a "
            "CUDA device tpumcia_torch always runs its CUDA kernel; use "
            "'auto' (the plain version runs only for CPU tensors)"
        )


def _to_device(images, device: torch.device) -> torch.Tensor:
    """Level images -> a tensor on ``device``; uint8 crosses as is, other
    host integer types as int32."""
    if isinstance(images, torch.Tensor):
        return images.to(device)
    host = images.astype(_level_dtype(images), copy=False)
    return torch.from_numpy(np.ascontiguousarray(host)).to(device)


def _level_dtype(images: np.ndarray):
    """What a host level array crosses to the device as: uint8 as is, any
    other integer type as int32."""
    return np.uint8 if images.dtype == np.uint8 else np.int32


def _host_or_device(a, device: torch.device):
    """How a batched entry holds an input: a tensor on an accelerator stays
    (moved to ``device``), a CPU tensor or array-like becomes a numpy array
    whose batches cross one at a time; None stays None."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a.to(device) if a.device.type != "cpu" else a.numpy()
    return np.asarray(a)


def _chw_levels(imgs: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) levels -> the kernel's contiguous (B, C, H, W) int32."""
    from tpumcia_torch.preprocess.normalize import as_int32

    return as_int32(imgs.permute(0, 3, 1, 2)).contiguous()


def _batch_levels(imgs: torch.Tensor, generator, *, synth_noise=0, synth_var=0.01):
    """A batch's kernel input: the (B, C, H, W) int32 levels, with
    ``synth_noise`` noise channels drawn from ``generator`` after a
    grayscale batch's own."""
    if synth_noise:
        from tpumcia_torch.preprocess.synth import noise_channels_chw

        return noise_channels_chw(imgs, generator, num_noise=synth_noise, var=synth_var)
    return _chw_levels(imgs)


def _batch_wire(st, keep_device: bool):
    """A batch's statistics -> (u32 wire, the NaN-cleaned f32 feature block
    or None)."""
    from tpumcia_torch.features.finalize import _finalize
    from tpumcia_torch.features.hybrid import _device_reduce_wire

    wire = _device_reduce_wire(st)
    return wire, torch.nan_to_num(_finalize(st).values) if keep_device else None


def _batch_fused_dispatch(
    imgs: torch.Tensor, mask, generator, *, levels, offset, keep_device,
    synth_noise=0, synth_var=0.01,
):
    """One batch on the device: (optional noise synth) -> sufficient
    statistics (masked when ``mask``, the (B, 1 or C, H, W) uint8 plane, is
    given) -> u32 wire (+ optionally the NaN-cleaned f32 feature block,
    which never leaves the device)."""
    from tpumcia_torch.features import cuda_glcm

    img = _batch_levels(imgs, generator, synth_noise=synth_noise, synth_var=synth_var)
    st = cuda_glcm.sufficient_stats(img, mask, levels=levels, offset=offset)
    return _batch_wire(st, keep_device)


def _prepare(images, mask, cfg: FeatureConfig, device: torch.device):
    """The entry checks every extraction shares -> (validated images,
    images on ``device``, mask plane on ``device`` or None)."""
    from tpumcia_torch.features.stats import prepare_mask

    check_use_pallas(cfg, device)
    images = _as_level_array(images, cfg.glcm.levels)
    if images.ndim != 4:
        raise ValueError(f"expected (B, H, W, C) images; got shape {tuple(images.shape)}")
    m = prepare_mask(mask, images.shape, device) if mask is not None else None
    return images, _to_device(images, device), m


def extract_features(
    images,
    mask=None,
    *,
    device="cuda",
    config: FeatureConfig | None = None,
    channel_names: list[str] | None = None,
    mesh=None,
) -> FeatureMatrix:
    """Extract the 23-per-channel feature set from a batch of level images
    on ``device`` (a CUDA device for the kernel; a CPU device runs its
    plain version).

    ``images``: (B, H, W, C) integer levels in [0, glcm.levels) (16-bit
    data goes through ``preprocess.quantize_to_levels`` first). ``mask``:
    optional (B, H, W, C) or (B, H, W) mask, nonzero selects a pixel (numpy,
    a sequence or a tensor). ``config.precision``: ``'hybrid'`` (float64
    values from the exact u32 wire, ~1e-7 relative on its float words),
    ``'exact'`` (difference histograms, float64 on the host) or
    ``'device'`` (float32 values as a tensor on ``device``). As in tpumcia,
    ``'hybrid'`` runs as ``'exact'`` at H*W >= 65536 and through the
    packed f32 wire above 256 levels. ``mesh``: a ``parallel.Mesh``; its
    slots' devices run the statistics (no u32 wire: the statistics are
    finalised as tpumcia's mesh branch finalises them) and ``device`` is
    not used.
    """
    if mesh is None:
        require_device(device, "extract_features")
    return _extract_features(
        images, mask, device=device, config=config, channel_names=channel_names, mesh=mesh,
    )


def _extract_features(images, mask=None, *, device, config, channel_names, mesh=None, timer=None):
    """:func:`extract_features`; ``timer``, a started
    ``utils.profiling.StageTimer``, gets the inputs (validation and
    host-to-device copies), stats kernel (with the wire reduction on the
    u32-wire branch) and finalize stages (the classic pipeline's split),
    each also a span."""
    cfg = config or FeatureConfig()
    if mesh is not None:
        from tpumcia_torch.parallel.mesh import check_mesh

        check_mesh(mesh)
    if cfg.include_morphology and mask is None:
        raise ValueError("include_morphology requires a mask")
    if not (cfg.include_intensity or cfg.include_glcm):
        raise ValueError("at least one feature family must be enabled")
    backends = {"exact": "host", "hybrid": "hybrid", "device": "device"}
    if cfg.precision not in backends:
        raise ValueError(f"unknown precision {cfg.precision!r}; one of {sorted(backends)}")
    backend = backends[cfg.precision]
    with stage("inputs", timer):
        if mesh is None:
            device = torch.device(device)
            images, imgs, m = _prepare(images, mask, cfg, device)
        else:
            # the sharded statistics check and place each slot's rows
            device = mesh.first_device
            images, imgs, m = _as_level_array(images, cfg.glcm.levels), None, None
            if images.ndim != 4:
                raise ValueError(f"expected (B, H, W, C) images; got shape {tuple(images.shape)}")

    from tpumcia_torch.features import cuda_glcm

    levels = cfg.glcm.levels
    hw = images.shape[1] * images.shape[2]
    if backend == "hybrid" and hw >= 65536:
        backend = "host"  # the hybrid wires' exact integers need < 2^16 pixels
    # the dstats sums are exact in f32 only below the B1d sizes; there the
    # statistics carry the difference histogram
    need_dh = backend == "host" or cuda_glcm.is_large(hw, levels)
    offsets = [tuple(o) for o in (cfg.glcm.offsets if cfg.include_glcm else [cfg.glcm.offset])]

    from tpumcia_torch.features.finalize import finalize_features
    from tpumcia_torch.features.hybrid import assemble_reduced

    def stats_multi(offsets):
        """One :class:`SuffStats` per offset, over the mesh when there is one."""
        if mesh is not None:
            from tpumcia_torch.parallel.sharding import sufficient_stats_sharded_multi

            return sufficient_stats_sharded_multi(
                images, mask, mesh=mesh, levels=levels, offsets=offsets,
                use_pallas=cfg.use_pallas, need_diff_hist=need_dh,
            )
        return cuda_glcm.sufficient_stats_multi(
            _chw_levels(imgs), m, levels=levels, offsets=offsets, need_diff=need_dh,
        )

    value_blocks, degenerate = [], None

    def add_block(values, flags):
        nonlocal degenerate
        value_blocks.append(values)
        flags = _to_host(flags)
        degenerate = flags if degenerate is None else degenerate | flags

    wire_branch = mesh is None and backend == "hybrid" and hybrid_wire_ok(cfg)
    with stage("stats_kernel", timer):
        if wire_branch:
            wire, _ = _batch_fused_dispatch(
                imgs, m, None, levels=levels, offset=offsets[0], keep_device=False,
            )
        elif len(offsets) > 1:
            all_stats = stats_multi(offsets)
        elif mesh is None:
            # one offset (or intensity only): one statistics pass
            stats = cuda_glcm.sufficient_stats(
                _chw_levels(imgs), m, levels=levels, offset=offsets[0], need_diff=need_dh,
            )
        else:
            (stats,) = stats_multi(offsets[:1])

    num_channels = images.shape[-1]
    with stage("finalize", timer):
        if wire_branch:
            from tpumcia_torch.features.hybrid import unpack_wire

            done = assemble_reduced(unpack_wire(_to_host(wire).view(np.uint32)), levels=levels)
            add_block(done.values, done.degenerate)
        elif len(offsets) > 1:
            if mesh is None and backend == "hybrid" and hybrid_wire_ok(
                    cfg, images.shape, multi_offset=True):
                # the whole offset list in one wire and one copy to the host
                from tpumcia_torch.features.hybrid import (
                    _device_reduce_wire_multi,
                    unpack_wire_multi,
                )

                wire = _to_host(_device_reduce_wire_multi(all_stats)).view(np.uint32)
                for i, r in enumerate(unpack_wire_multi(wire, len(all_stats))):
                    done = assemble_reduced(
                        r, levels=levels, include_intensity=cfg.include_intensity and i == 0,
                        include_glcm=True,
                    )
                    add_block(done.values, done.degenerate)
            else:
                for i, stats in enumerate(all_stats):
                    done = finalize_features(
                        stats, include_intensity=cfg.include_intensity and i == 0,
                        include_glcm=True, backend=backend,
                    )
                    add_block(done.values, done.degenerate)
        else:
            done = finalize_features(
                stats, include_intensity=cfg.include_intensity,
                include_glcm=cfg.include_glcm, backend=backend,
            )
            add_block(done.values, done.degenerate)

        if cfg.include_morphology:
            from tpumcia_torch.features.morphology import morphology_features
            from tpumcia_torch.features.stats import prepare_mask

            if m is None:  # over a mesh: the mask plane on the first slot's device
                m = prepare_mask(mask, images.shape, device)

            # the mask plane's (B, 1 or C, 8) shape features, a shared mask's
            # for every channel
            morph = morphology_features(m.permute(0, 2, 3, 1), device=device)
            morph = morph.expand(-1, num_channels, -1)
            morph = morph.reshape(morph.shape[0], -1)
            if not isinstance(value_blocks[0], torch.Tensor):
                morph = morph.cpu().numpy().astype(value_blocks[0].dtype)
            value_blocks.append(morph)
    names = registry.feature_names(
        num_channels,
        include_intensity=cfg.include_intensity,
        include_glcm=cfg.include_glcm,
        channel_names=channel_names,
        glcm_pair_labels=cfg.glcm.pair_labels,
        include_morphology=cfg.include_morphology,
    )
    if len(value_blocks) == 1:
        values = value_blocks[0]
    elif isinstance(value_blocks[0], torch.Tensor):
        values = torch.cat(value_blocks, dim=1)
    else:
        values = np.concatenate(value_blocks, axis=1)
    return FeatureMatrix(
        values=values,
        names=names,
        num_channels=num_channels,
        degenerate=degenerate,
        config=cfg,
        channel_names=list(channel_names) if channel_names else None,
    )


@dataclass
class PendingFeatureMatrix:
    """Batched extraction whose wires are still on the device.
    ``device_values`` (if requested) can feed device work (the head fit and
    sweeps) before :meth:`result` copies the wires to the host."""

    wires: list
    slices: list
    n: int
    names: list[str]
    num_channels: int
    config: FeatureConfig
    channel_names: list[str] | None
    device_values: Any = None  # (n, F) f32 tensor, trimmed, or None

    def result(self) -> FeatureMatrix:
        """Copy each batch's wire to the host and assemble the float64
        matrix."""
        from tpumcia_torch.features.hybrid import assemble_reduced, unpack_wire

        levels = self.config.glcm.levels
        values, degenerate = [], []
        for w, sl in zip(self.wires, self.slices):
            done = assemble_reduced(
                unpack_wire(w.cpu().numpy().view(np.uint32)), levels=levels
            )
            keep = sl.stop - sl.start
            values.append(done.values[:keep])
            degenerate.append(np.asarray(done.degenerate)[:keep])
        return FeatureMatrix(
            values=np.concatenate(values),
            names=self.names,
            num_channels=self.num_channels,
            degenerate=np.concatenate(degenerate),
            config=self.config,
            channel_names=self.channel_names,
            device_values=self.device_values,
        )


def extract_features_pending(
    images,
    mask=None,
    *,
    device="cuda",
    batch_size: int = 2048,
    config: FeatureConfig | None = None,
    channel_names: list[str] | None = None,
    keep_device_values: bool = False,
    synth_noise: int = 0,
    synth_var: float = 0.01,
    synth_seed: int = 0,
    in_flight: int = 8,
    timer=None,
) -> PendingFeatureMatrix:
    """Run the batched hybrid extraction on ``device`` and return before the
    wires are copied to the host.

    ``images``: (N, H, W, C) levels with an optional (N, H, W[, C]) mask,
    or (N, H, W) grayscale with ``synth_noise > 0`` noise channels
    synthesized per batch (batch ``i`` draws from
    ``synth.synth_batch_seed(synth_seed, i)``; no mask). The last batch is
    padded by wrapping around to the first images (and their mask rows), so
    every batch has one shape; the pad rows are dropped from the result.

    Images and masks on the host stay there: each batch is sliced and
    wrap-padded on the host and sent to a CUDA device through a pinned
    buffer on a side stream while the previous batch computes. ``in_flight``
    bounds the batches enqueued ahead of the device, and with them the
    batches resident on it: batch ``i`` is not sent before batch
    ``i - in_flight`` has finished. A tensor already on the device is
    sliced there.
    """
    from tpumcia_torch.features import cuda_glcm
    from tpumcia_torch.features.stats import check_mask_shape, mask_plane
    from tpumcia_torch.io.staging import HostStager, rows_to_device, take
    from tpumcia_torch.preprocess.synth import synth_batch_seed

    device = torch.device(require_device(device, "extract_features_pending"))
    cfg = config or FeatureConfig()
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1; got {batch_size}")
    if in_flight < 1:
        raise ValueError(f"in_flight must be >= 1; got {in_flight}")
    check_use_pallas(cfg, device)
    images = _as_level_array(images, cfg.glcm.levels)
    n = len(images)
    if synth_noise and images.ndim != 3:
        raise ValueError("synth_noise expects (N, H, W) grayscale input")
    if synth_noise and mask is not None:
        raise ValueError("synth_noise does not compose with masks")
    if not synth_noise and images.ndim != 4:
        raise ValueError(f"expected (N, H, W, C) images; got shape {tuple(images.shape)}")
    if not batched_fast_path_ok(images.shape, cfg):
        # the pending path IS the hybrid wire pipeline: another config
        # would come back mislabeled; extract_features(_batched) takes it
        raise ValueError(
            "extract_features_pending requires the hybrid fast path "
            f"{FAST_PATH_REQS}; got precision={cfg.precision!r}, "
            f"offsets={cfg.glcm.offsets}, morphology={cfg.include_morphology}, "
            f"image shape {tuple(images.shape)}"
        )
    num_channels = images.shape[-1] if synth_noise == 0 else 1 + synth_noise
    if mask is not None:
        check_mask_shape(mask, images.shape)
    if timer is not None:
        timer.start()
    images, mask = _host_or_device(images, device), _host_or_device(mask, device)
    stager = HostStager(device) if device.type == "cuda" else None

    batch_size = min(batch_size, n)
    num_batches = math.ceil(n / batch_size)
    slices = [
        slice(i * batch_size, min((i + 1) * batch_size, n))
        for i in range(num_batches)
    ]
    offset = tuple(cfg.glcm.offset)

    def pad_batch(arr, sl, is_mask=False):
        # wrap-around pad: one batch shape for every launch
        short = batch_size - (sl.stop - sl.start)
        parts = [arr[sl], arr[:short]] if short else [arr[sl]]
        if isinstance(arr, torch.Tensor):  # on the device already
            b = torch.cat(parts) if short else parts[0]
            return (b != 0).to(torch.uint8) if is_mask else b
        if is_mask:
            return rows_to_device([p != 0 for p in parts], device, np.uint8, stager, "mask")
        return rows_to_device(parts, device, _level_dtype(arr), stager)

    wires, feats, done = [], [], []
    for i, sl in enumerate(slices):
        # _batch_fused_dispatch's steps, each a stage
        with stage("inputs", timer):
            if i >= in_flight and done[i - in_flight] is not None:
                done[i - in_flight].synchronize()  # the bound on resident batches
            imgs_b = pad_batch(images, sl)
            mask_b = None if mask is None else pad_batch(mask, sl, is_mask=True)
            imgs_b = take(imgs_b)
            mask_b = None if mask_b is None else mask_plane(take(mask_b))
        with stage("synth", timer):
            gen = None
            if synth_noise:
                gen = torch.Generator(device=device)
                gen.manual_seed(synth_batch_seed(synth_seed, i))
            img = _batch_levels(imgs_b, gen, synth_noise=synth_noise, synth_var=synth_var)
        with stage("stats_kernel", timer):
            st = cuda_glcm.sufficient_stats(img, mask_b, levels=cfg.glcm.levels, offset=offset)
        with stage("wire_features", timer):
            wire, f = _batch_wire(st, keep_device_values)
        wires.append(wire)
        if keep_device_values:
            feats.append(f)
        event = None
        if device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
        done.append(event)

    device_values = torch.cat(feats)[:n] if keep_device_values else None
    names = registry.feature_names(num_channels, channel_names=channel_names)
    return PendingFeatureMatrix(
        wires=wires,
        slices=slices,
        n=n,
        names=names,
        num_channels=num_channels,
        config=cfg,
        channel_names=list(channel_names) if channel_names else None,
        device_values=device_values,
    )


def extract_features_batched(
    images,
    mask=None,
    *,
    device="cuda",
    batch_size: int = 2048,
    config: FeatureConfig | None = None,
    channel_names: list[str] | None = None,
    keep_device_values: bool = False,
    in_flight: int = 8,
) -> FeatureMatrix:
    """Large-collection extraction in fixed-size batches: the fused fast
    path (:func:`extract_features_pending`, at most ``in_flight`` batches
    ahead of the device) when the config is eligible, else
    :func:`extract_features` per batch, concatenated on the host.
    ``keep_device_values=True`` also returns the device-resident NaN-cleaned
    f32 matrix (``FeatureMatrix.device_values``) and requires the fast
    path."""
    require_device(device, "extract_features_batched")
    return _extract_features_batched(
        images, mask, device=device, batch_size=batch_size, config=config,
        channel_names=channel_names, keep_device_values=keep_device_values,
        in_flight=in_flight,
    )


def _extract_features_batched(
    images, mask=None, *, device, batch_size, config, channel_names,
    keep_device_values=False, in_flight=8, timer=None,
) -> FeatureMatrix:
    """:func:`extract_features_batched`; ``timer``, a started
    ``StageTimer``, gets the per-batch calls' stages (the fused path
    restarts it)."""
    cfg = config or FeatureConfig()
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1; got {batch_size}")
    images = _as_level_array(images, cfg.glcm.levels)
    n = len(images)
    fast = images.ndim == 4 and batched_fast_path_ok(images.shape, cfg)
    if keep_device_values and not fast:
        raise ValueError(
            f"keep_device_values=True requires the hybrid fast path {FAST_PATH_REQS} "
            "— the other paths have no device-resident feature copy; got "
            f"precision={cfg.precision!r}, offsets={cfg.glcm.offsets}, "
            f"morphology={cfg.include_morphology}, image shape {tuple(images.shape)}"
        )
    if n <= batch_size and not (fast and keep_device_values):
        return _extract_features(
            images, mask, device=device, config=cfg, channel_names=channel_names,
            timer=timer,
        )
    if fast:
        return extract_features_pending(
            images, mask, device=device, batch_size=batch_size, config=cfg,
            channel_names=channel_names, keep_device_values=keep_device_values,
            in_flight=in_flight, timer=timer,
        ).result()
    fms = [
        _extract_features(
            images[i:i + batch_size],
            None if mask is None else mask[i:i + batch_size],
            device=device, config=cfg, channel_names=channel_names, timer=timer,
        )
        for i in range(0, n, batch_size)
    ]
    return FeatureMatrix(
        values=np.concatenate([f.to_numpy() for f in fms]),
        names=fms[0].names,
        num_channels=fms[0].num_channels,
        degenerate=np.concatenate([f.degenerate for f in fms]),
        config=cfg,
        channel_names=fms[0].channel_names,
    )


# bounded scan: raw 16-bit data violates the level contract densely, so a
# prefix sample catches the realistic mistake without a full scan
_LEVEL_CHECK_SAMPLE = 1_000_000


def _as_level_array(images, levels: int = 256, sample: int = _LEVEL_CHECK_SAMPLE):
    """Validate the level-image contract: integer values in [0, levels).

    Float input is always rejected. A host array (numpy, or a CPU tensor)
    whose integer dtype can hold out-of-contract values (too wide, e.g. raw
    uint16 into a 256-level extraction, or signed) has a bounded prefix
    sample value-checked. CUDA tensors are trusted: checking them would cost
    a device-to-host round trip.
    """
    if isinstance(images, torch.Tensor):
        if images.dtype.is_floating_point or images.dtype.is_complex:
            raise TypeError(
                "extract_features expects integer level images; got "
                f"{images.dtype}"
            )
        if images.dim() == 0:
            raise TypeError("extract_features expects a batched image array, got a 0-d scalar")
        if images.device.type == "cpu":
            _check_level_sample(images.numpy(), levels, sample)
        return images
    arr = np.asarray(images)
    if arr.dtype.kind == "f":
        raise TypeError(
            "extract_features expects integer level images; for float/16-bit "
            "data quantize to levels first"
        )
    if arr.ndim == 0:
        raise TypeError("extract_features expects a batched image array, got a 0-d scalar")
    _check_level_sample(arr, levels, sample)
    return arr


def _check_level_sample(arr: np.ndarray, levels: int, sample: int) -> None:
    if arr.dtype.kind in "iu" and (
        np.iinfo(arr.dtype).max >= levels or np.iinfo(arr.dtype).min < 0
    ):
        # bound along axis 0 first: ravel() of a non-contiguous array would
        # copy all of it, not just the sampled prefix
        per_row = max(1, int(np.prod(arr.shape[1:], dtype=np.int64)))
        rows = max(1, sample // per_row)
        sampled = np.ravel(arr[:rows])[:sample]
        if sampled.size and (int(sampled.max()) >= levels or int(sampled.min()) < 0):
            raise TypeError(
                f"extract_features got {arr.dtype} images with values outside "
                f"[0, glcm.levels={levels}); quantize to levels first"
            )
