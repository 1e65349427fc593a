"""Manifest-driven streaming feature extraction with resume (counterpart
of ``tpumcia.pipeline.streaming``).

The reference has no failure handling: an interrupted run just leaves the
pandas DataFrame partially filled (its own stored output shows the run
stopped at 11 949/12 000 images — ipynb:353, SURVEY.md §5). Here extraction
over a large object collection is split into shards; each completed shard is
written as an ``.npz`` plus a manifest record, so a restarted run skips
finished shards and only recomputes the remainder (BASELINE.json config 5:
"streaming sharded pipeline ... over millions of objects").

The shard files (``values``, ``degenerate``, ``indices``, ``labels``), the
manifests (``manifest.json``, the ``manifest.jsonl`` append log with its
header line, ``manifest_pNNNN.*`` per process) and ``progress*.jsonl`` are
written as tpumcia writes them: a directory started by one package is
resumed and loaded by the other.

On a CUDA device a shard never waits for the whole collection: the prefetch
worker copies each shard through a ring of ``prefetch_depth + 1`` pinned
buffers on a side stream (``io.staging``), the consumer's stream waits for
that copy's event only, and each shard's wire goes back to the host on a
copy stream while the next shard computes.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from tpumcia_torch.config import FeatureConfig
from tpumcia_torch.features import registry
from tpumcia_torch.features.extract import FeatureMatrix, extract_features
from tpumcia_torch.utils.device import require_device


@dataclass
class StreamResult:
    features: FeatureMatrix
    labels: np.ndarray | None
    shards_computed: int
    shards_skipped: int
    images_per_second: float
    # per-stage profile (seconds summed over computed shards): where the
    # streaming wall clock went — 'ingest_wait' is time the consumer spent
    # blocked on the decode/upload pipeline (host bound), 'device' the wait
    # for a shard's result and its assembly, 'save' the shard write
    profile: dict = field(default_factory=dict)


def _manifest_path(out_dir: Path, process_index: int = 0, process_count: int = 1) -> Path:
    # multi-process runs write one manifest per process (no cross-process
    # file races); readers always merge every manifest*.json{,l} they find,
    # so resume works across runs with different process counts
    if process_count > 1:
        return out_dir / f"manifest_p{process_index:04d}.json"
    return out_dir / "manifest.json"


def _manifest_jsonl_path(
    out_dir: Path, process_index: int = 0, process_count: int = 1
) -> Path:
    # in-progress shard completions append here in O(1) (one line per shard;
    # a full-JSON rewrite would be O(S^2) cumulative host I/O at the
    # millions-of-objects scale this subsystem exists for); a successful run
    # compacts the log into the .json and removes it
    if process_count > 1:
        return out_dir / f"manifest_p{process_index:04d}.jsonl"
    return out_dir / "manifest.jsonl"


def _read_manifest_jsonl(path: Path) -> dict:
    """Parse one append-log manifest. Tolerates a torn final line (a crash
    mid-append): the shard's npz precedes its manifest line, so a lost line
    merely recomputes that shard on resume."""
    m = {"shards": {}, "version": 2}
    for line in path.read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue  # torn tail line
        if "sid" in rec:
            sid = rec.pop("sid")
            m["shards"][sid] = rec
        elif "config_tag" in rec:
            m["config_tag"] = rec["config_tag"]
    return m


def _load_merged_manifest(out_dir: Path) -> dict:
    """Union of all manifest files in ``out_dir`` — ``.json`` and append-log
    ``.jsonl``, any mix (single- and multi-process runs interleave cleanly:
    shard ids are disjoint by start index)."""
    merged = {"shards": {}, "version": 1}
    for p in sorted(out_dir.glob("manifest*.json")) + sorted(
        out_dir.glob("manifest*.jsonl")
    ):
        m = (
            _read_manifest_jsonl(p)
            if p.suffix == ".jsonl"
            else json.loads(p.read_text())
        )
        merged["shards"].update(m.get("shards", {}))
        tag = m.get("config_tag")
        if tag is not None:
            prev = merged.get("config_tag")
            if prev is not None and prev != tag:
                raise ValueError(
                    f"conflicting config_tags in {out_dir}: {prev!r} vs {tag!r}"
                )
            merged["config_tag"] = tag
    return merged


def _wait_all_shards_done(
    out_dir: Path, n: int, shard_size: int, *, timeout_s: float = 600.0
) -> None:
    """Barrier for launcher-managed multi-process splits (no
    ``torch.distributed`` group to call): poll the merged manifest in the
    shared ``out_dir`` until every shard of the full ``[0, n)`` index space
    is ``done``. Raises after ``timeout_s`` naming the missing shards —
    loud beats a silently partial assembled matrix."""
    expected = [f"shard_{s:09d}" for s in range(0, n, shard_size)]
    deadline = time.perf_counter() + timeout_s
    while True:
        shards = _load_merged_manifest(out_dir)["shards"]
        missing = [
            sid for sid in expected
            if shards.get(sid, {}).get("status") != "done"
        ]
        if not missing:
            return
        if time.perf_counter() > deadline:
            raise RuntimeError(
                f"stream_extract barrier timed out after {timeout_s:.0f}s: "
                f"{len(missing)}/{len(expected)} shards not done in "
                f"{out_dir} (first missing: {missing[0]}) — a sibling "
                "process crashed or is still running; raise "
                "TPUMCIA_STREAM_BARRIER_TIMEOUT if it is just slow"
            )
        time.sleep(0.5)


def _load_manifest(out_dir: Path, process_index: int = 0, process_count: int = 1) -> dict:
    """This process's manifest view: compacted .json plus any .jsonl tail an
    interrupted previous run left behind (so compaction never drops them)."""
    p = _manifest_path(out_dir, process_index, process_count)
    manifest = (
        json.loads(p.read_text()) if p.exists() else {"shards": {}, "version": 1}
    )
    pl = _manifest_jsonl_path(out_dir, process_index, process_count)
    if pl.exists():
        tail = _read_manifest_jsonl(pl)
        manifest["shards"].update(tail["shards"])
        if manifest.get("config_tag") is None:
            manifest["config_tag"] = tail.get("config_tag")
    return manifest


def _save_manifest(
    out_dir: Path, manifest: dict, process_index: int = 0, process_count: int = 1
) -> None:
    path = _manifest_path(out_dir, process_index, process_count)
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps(manifest, indent=2))
    os.replace(tmp, path)  # atomic on POSIX


def _compact_manifest(
    out_dir: Path, manifest: dict, process_index: int = 0, process_count: int = 1
) -> None:
    """Fold the append log into the .json and remove it. Crash-safe: the
    .json lands atomically BEFORE the .jsonl is unlinked, so a crash in
    between leaves both with identical union."""
    _save_manifest(out_dir, manifest, process_index, process_count)
    pl = _manifest_jsonl_path(out_dir, process_index, process_count)
    if pl.exists():
        pl.unlink()


def _distributed_topology() -> tuple[int, int]:
    """(rank, world size) of the ``torch.distributed`` group when one is
    initialized, else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def stream_extract(
    fetch: Callable[[np.ndarray], tuple],
    n: int,
    out_dir: str | Path,
    *,
    device="cuda",
    shard_size: int = 1024,
    config: FeatureConfig | None = None,
    config_tag: str | None = None,
    mesh=None,
    prefetch_depth: int = 2,
    stage_on_device: bool = True,
    process_index: int | None = None,
    process_count: int | None = None,
    channel_names: list[str] | None = None,
    barrier_timeout_s: float | None = None,
) -> StreamResult:
    """Extract features over ``n`` objects in resumable shards on ``device``.

    ``fetch(idx)`` returns ``(images, mask_or_None, labels_or_None)`` for the
    given index array (numpy arrays or tensors; a tensor already on an
    accelerator is trusted and used as it is). Fetches run on a background
    thread with ``prefetch_depth`` shards prepared ahead
    (``io.loader.PrefetchLoader``), so host decode of shard i+1 overlaps the
    device reduction of shard i; ``prefetch_depth=0`` fetches synchronously.
    With ``mesh`` (a ``parallel.Mesh``) each shard is computed over the
    mesh's slots by ``extract_features(mesh=)``, ``device`` is not used, and
    ``stage_on_device`` and the wire do not apply, as in tpumcia; over a
    mesh that spans processes every rank computes every shard's rows on its
    slots and rank 0 alone writes the shard files and manifests.

    ``stage_on_device``: a second prefetch worker also uploads each shard's
    images/mask (pinned buffers, a side stream), so the H2D copy overlaps
    the previous shard's device reduction instead of serialising with it.
    Without it the consumer uploads each shard itself, with a plain copy.

    **Multi-process (per-process feed)**: in a ``torch.distributed`` run the
    pending shards are split round-robin across ranks and each process
    fetches/decodes/uploads ONLY its own shard range. Each process computes
    on its own device, writes its own shards + per-process manifest into the
    shared ``out_dir``, then all processes barrier and every one assembles
    the full merged matrix. ``process_index``/``process_count`` override the
    autodetected topology (useful for launcher-managed splits or tests).

    The barrier under a ``torch.distributed`` run is a collective; under an
    explicit launcher-managed split it polls the shared manifest until
    every shard of the full index space is done (``barrier_timeout_s``,
    default 600 s / env ``TPUMCIA_STREAM_BARRIER_TIMEOUT``), then raises
    rather than return a silently partial matrix. Pass
    ``barrier_timeout_s=0`` to skip the wait and assemble whatever shards
    exist — for sequential launchers that invoke one process at a time and
    know only the last call sees the full collection.
    """
    if mesh is None:
        require_device(device, "stream_extract")
    cfg = config or FeatureConfig()
    if n < 1:
        raise ValueError(f"stream_extract needs n >= 1 objects; got {n}")
    if shard_size < 1:
        raise ValueError(f"shard_size must be >= 1; got {shard_size}")
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if process_count is None:
        if process_index is not None:
            raise ValueError(
                "stream_extract: process_index was given without "
                "process_count — pass both (or neither, for autodetection)"
            )
        # a cross-process `mesh` would compute each shard over every
        # process — the per-process feed split only applies without one
        process_index, process_count = _distributed_topology() if mesh is None else (0, 1)
    elif process_count > 1:
        if process_index is None:
            # defaulting the index would make EVERY process take index 0:
            # identical shard ownership, racing writes, and 1-1/N of the
            # collection never computed by anyone
            raise ValueError(
                "stream_extract: an explicit process_count > 1 requires an "
                "explicit process_index (autodetection covers the "
                "torch.distributed case when both are omitted)"
            )
        if mesh is not None:
            # the round-robin pending split under SPMD dispatches would
            # have each process issue collectives over a different shard
            # list — a deadlock, not a feed split
            raise ValueError(
                "stream_extract: per-process feed (process_count > 1) and "
                "a cross-process mesh are mutually exclusive — drop the "
                "mesh (each process computes locally) or the explicit split"
            )
    process_index = process_index or 0
    if not (0 <= process_index < process_count):
        raise ValueError(
            f"process_index {process_index} out of range for "
            f"process_count {process_count}"
        )
    if mesh is None:
        device = torch.device(device)
    else:
        from tpumcia_torch.parallel.mesh import check_mesh

        device = check_mesh(mesh).first_device
    # over a mesh that spans processes, rank 0 writes for all of them
    writer = mesh is None or mesh.rank == 0
    merged = _load_merged_manifest(out_dir)
    manifest = _load_manifest(out_dir, process_index, process_count)
    tag = config_tag or "default"
    if merged.get("config_tag") not in (None, tag):
        raise ValueError(
            f"manifest at {out_dir} was produced with config_tag="
            f"{merged.get('config_tag')!r}, refusing to mix with {tag!r}"
        )
    manifest["config_tag"] = tag

    from tpumcia_torch.utils.logging import MetricsLogger

    log_name = (
        "progress.jsonl"
        if process_count == 1
        else f"progress_p{process_index:04d}.jsonl"
    )
    log = MetricsLogger(out_dir / log_name, echo=False) if writer else None
    # resolve pending shards up front so prefetch only decodes what runs;
    # skip decisions use the MERGED manifest view (shards any process — or a
    # prior run at any process count — completed are not recomputed)
    pending: list[tuple[int, int]] = []
    skipped = 0
    for start in range(0, n, shard_size):
        sid = f"shard_{start:09d}"
        stop = min(start + shard_size, n)
        entry = merged["shards"].get(sid)
        if (
            entry
            and entry.get("status") == "done"
            and (out_dir / f"{sid}.npz").exists()
        ):
            skipped += 1
        else:
            pending.append((start, stop))
    if process_count > 1:
        # round-robin ownership keyed on the GLOBAL shard ordinal (not the
        # pending list, which can differ across processes mid-resume): each
        # shard is fetched, computed and written by exactly one process
        pending = [
            (s, e)
            for (s, e) in pending
            if (s // shard_size) % process_count == process_index
        ]
    spans = mesh is not None and mesh.spans_processes
    if spans:
        # every rank runs the collectives of every pending shard: none may
        # read the manifests after rank 0 has begun to write
        from tpumcia_torch.parallel.distributed import barrier

        barrier(mesh.group)

    from tpumcia_torch.features.extract import (
        _as_level_array,
        _host_or_device,
        _level_dtype,
        batched_fast_path_ok,
        check_use_pallas,
    )
    from tpumcia_torch.features.stats import check_mask_shape, mask_plane
    from tpumcia_torch.io.staging import HostFetch, HostStager, rows_to_device, take

    check_use_pallas(cfg, device)
    on_card = device.type == "cuda"
    # the prefetch queue, the batch being staged and the one being computed
    # each hold a buffer: prefetch_depth + 1 of them, whatever the shard count
    stager = None
    if on_card and stage_on_device and mesh is None:
        stager = HostStager(device, slots=prefetch_depth + 1)
    checked = 0  # shards whose levels were checked (on the thread that uploads)

    def upload(batch):
        """Check a fetched shard's level contract where it lies on the host
        (a full prefix scan on the first shard, a small sample on later
        ones: the realistic violation, raw 16-bit data, is dense) and send
        it to the device: images as they are, the mask binarized."""
        nonlocal checked
        images, mask, labels = batch
        # numpy where it lies on the host, a tensor on the device otherwise
        # (trusted, used as it is)
        images, mask = _host_or_device(images, device), _host_or_device(mask, device)
        images = _as_level_array(
            images, cfg.glcm.levels, sample=1_000_000 if checked == 0 else 4096,
        )
        checked += 1
        if mask is not None:
            check_mask_shape(mask, images.shape)
        if mesh is not None:
            return images, mask, labels  # the sharded statistics place each slot's rows
        if isinstance(images, np.ndarray):
            images = rows_to_device([images], device, _level_dtype(images), stager)
        if isinstance(mask, np.ndarray):
            mask = rows_to_device([mask != 0], device, np.uint8, stager, "mask")
        elif mask is not None:
            mask = (mask != 0).to(torch.uint8)
        return images, mask, labels

    stage = upload if stage_on_device and mesh is None else None
    if prefetch_depth > 0 and len(pending) > 1:
        from tpumcia_torch.io.loader import PrefetchLoader

        chunks = [np.arange(s, e) for s, e in pending]
        batches = iter(
            PrefetchLoader(
                fetch, chunks=chunks, depth=prefetch_depth, stage=stage
            )
        )
    else:
        if stage is None:
            batches = (fetch(np.arange(s, e)) for s, e in pending)
        else:
            batches = (stage(fetch(np.arange(s, e))) for s, e in pending)

    def next_batch():
        batch = next(batches)
        return batch if stage is not None else upload(batch)

    # the hybrid single-offset config additionally pipelines the OUTPUT
    # side: shard i's fused stats->wire dispatch is enqueued, then shard
    # i-1's wire is fetched/assembled/saved while the device computes —
    # the per-shard wire round trip leaves the critical path
    # shared predicate with extract_features_batched (the pixel-count bound
    # is applied per shard below, once the first batch's shape is known)
    offsets = cfg.glcm.offsets if cfg.include_glcm else [cfg.glcm.offset]
    wire_mode = mesh is None and batched_fast_path_ok(None, cfg)

    computed = 0
    computed_imgs = 0  # actual image count (final shard may be partial)
    profile = {"ingest_wait_s": 0.0, "device_s": 0.0, "save_s": 0.0}
    t0 = time.perf_counter()
    names = None
    num_channels = None

    def save_shard(start, stop, values, degenerate, labels):
        nonlocal computed, computed_imgs
        computed += 1
        computed_imgs += int(stop - start)
        if not writer:
            return
        sid = f"shard_{start:09d}"
        shard_file = out_dir / f"{sid}.npz"
        payload = {
            "values": np.asarray(values),
            "degenerate": np.asarray(degenerate),
            "indices": np.arange(start, stop),
        }
        if labels is not None:
            payload["labels"] = np.asarray(labels)
        tmp = shard_file.with_suffix(".tmp.npz")
        # uncompressed: feature shards are small and zlib is host-CPU-bound
        np.savez(tmp, **payload)
        os.replace(tmp, shard_file)
        entry = {
            "status": "done",
            "start": int(start),
            "stop": int(stop),
            "file": shard_file.name,
        }
        manifest["shards"][sid] = entry
        # O(1) append (one line per shard) — the full-JSON rewrite would be
        # O(S^2) cumulative host I/O over a large collection; the log is
        # compacted into the .json on successful completion
        jsonl = _manifest_jsonl_path(out_dir, process_index, process_count)
        header = (
            "" if jsonl.exists()
            else json.dumps({"version": 2, "config_tag": manifest["config_tag"]}) + "\n"
        )
        with open(jsonl, "a") as f:
            f.write(header + json.dumps({"sid": sid, **entry}) + "\n")
        elapsed_so_far = time.perf_counter() - t0
        log.log(
            "shard_done",
            shard=sid,
            images=int(stop - start),
            images_per_second=round(computed_imgs / elapsed_so_far, 1),
            ingest_wait_s=round(profile["ingest_wait_s"], 3),
            device_s=round(profile["device_s"], 3),
            save_s=round(profile["save_s"], 3),
            degenerate_channels=int(np.asarray(payload["degenerate"]).sum()),
        )

    first_batch = None
    if wire_mode and pending:
        t_wait = time.perf_counter()
        first_batch = next_batch()
        profile["ingest_wait_s"] += time.perf_counter() - t_wait
        shape = take(first_batch[0]).shape
        if shape[1] * shape[2] >= 65536:
            wire_mode = False  # hybrid wire needs < 2^16 pixels/channel

    if wire_mode:
        from tpumcia_torch.features.extract import _batch_fused_dispatch
        from tpumcia_torch.features.hybrid import assemble_reduced, unpack_wire

        offset = tuple(offsets[0])
        copy_stream = torch.cuda.Stream(device) if on_card else None
        prev = None  # (start, stop, the wire's copy to the host, labels)

        def finish(prev):
            start, stop, wire, labels = prev
            t_fetch = time.perf_counter()
            done = assemble_reduced(
                unpack_wire(wire.numpy().view(np.uint32)), levels=cfg.glcm.levels
            )
            t_save = time.perf_counter()
            profile["device_s"] += t_save - t_fetch
            save_shard(start, stop, done.values, np.asarray(done.degenerate), labels)
            profile["save_s"] += time.perf_counter() - t_save

        for start, stop in pending:
            if first_batch is not None:
                images, mask, labels = first_batch
                first_batch = None
            else:
                t_wait = time.perf_counter()
                images, mask, labels = next_batch()
                profile["ingest_wait_s"] += time.perf_counter() - t_wait
            images = take(images)
            if num_channels is None:
                num_channels = int(images.shape[-1])
            # a partial final shard launches at its own size: no kernel is
            # compiled per shape here, so nothing is padded and no pad row
            # can reach a shard file
            wire, _ = _batch_fused_dispatch(  # asynchronous on a CUDA device
                images, None if mask is None else mask_plane(take(mask)), None,
                levels=cfg.glcm.levels, offset=offset, keep_device=False,
            )
            # the copy waits for this wire only, not for the next shard
            wire = HostFetch(wire, copy_stream)
            if prev is not None:
                finish(prev)  # overlaps the dispatch and the copy above
            prev = (start, stop, wire, labels)
        if prev is not None:
            finish(prev)
        if num_channels is not None:
            names = _config_feature_names(cfg, num_channels, channel_names)
    else:
        for start, stop in pending:
            if first_batch is not None:
                images, mask, labels = first_batch
                first_batch = None
                t_dev = time.perf_counter()
            else:
                t_wait = time.perf_counter()
                images, mask, labels = next_batch()
                t_dev = time.perf_counter()
                profile["ingest_wait_s"] += t_dev - t_wait
            fm = extract_features(
                take(images), None if mask is None else take(mask),
                device=device, config=cfg, channel_names=channel_names, mesh=mesh,
            )
            names = fm.names
            values = fm.to_numpy()
            t_save = time.perf_counter()
            profile["device_s"] += t_save - t_dev
            save_shard(start, stop, values, fm.degenerate, labels)
            profile["save_s"] += time.perf_counter() - t_save
    elapsed = time.perf_counter() - t0
    if writer:
        log.close()
        # successful completion of this process's pending shards: compact
        # the append log into the .json (merged readers accept either/both)
        _compact_manifest(out_dir, manifest, process_index, process_count)

    if spans or process_count > 1:
        if spans or _distributed_topology()[1] > 1:
            # all shards must be on disk before any process assembles
            from tpumcia_torch.parallel.distributed import barrier

            barrier(mesh.group if spans else None)
        else:
            # launcher-managed split without a torch.distributed group:
            # there is no collective to barrier on, but every process
            # writes to the SAME out_dir (required for manifest merging), so
            # the shared manifest is the barrier — poll it until every shard
            # of the full index space is done. Bounded: a crashed sibling
            # raises here instead of this process returning a silently
            # partial matrix. barrier_timeout_s=0 opts out (sequential
            # launchers).
            if barrier_timeout_s is None:
                barrier_timeout_s = float(
                    os.environ.get("TPUMCIA_STREAM_BARRIER_TIMEOUT", 600.0)
                )
            if barrier_timeout_s > 0:
                _wait_all_shards_done(
                    out_dir, n, shard_size, timeout_s=barrier_timeout_s
                )
    if names is None:
        # this process computed no shards (full resume, or another process
        # owned them all) — rebuild the column names from the config so the
        # assembled matrix matches what the computing branch would carry
        nc = num_channels
        if nc is None:
            any_entry = next(
                iter(_load_merged_manifest(out_dir)["shards"].values()), None
            )
            if any_entry is not None:
                with np.load(out_dir / any_entry["file"]) as z:
                    nc = int(z["degenerate"].shape[1])
        if nc is not None:
            names = _config_feature_names(cfg, nc, channel_names)
    fm, labels = load_feature_shards(
        out_dir, names=names, config=cfg, channel_names=channel_names
    )
    rate = computed_imgs / elapsed if elapsed > 0 and computed else 0.0
    profile = {k: round(v, 3) for k, v in profile.items()}
    profile["total_s"] = round(elapsed, 3)
    if process_count > 1:
        profile["process_index"] = process_index
        profile["process_count"] = process_count
    return StreamResult(
        features=fm,
        labels=labels,
        shards_computed=computed,
        shards_skipped=skipped,
        images_per_second=rate,
        profile=profile,
    )


def _config_feature_names(
    cfg: FeatureConfig, num_channels: int, channel_names=None
) -> list[str]:
    """Mirror ``extract_features``' column-name construction so shard
    artifacts carry identical columns whichever branch (or process)
    produced them."""
    return registry.feature_names(
        num_channels,
        include_intensity=cfg.include_intensity,
        include_glcm=cfg.include_glcm,
        channel_names=channel_names,
        glcm_pair_labels=cfg.glcm.pair_labels,
        include_morphology=cfg.include_morphology,
    )


def stream_extract_h5(
    source,
    out_dir: str | Path,
    *,
    device="cuda",
    shard_size: int = 1024,
    config: FeatureConfig | None = None,
    config_tag: str | None = None,
    mesh=None,
    prefetch_depth: int = 2,
    target_hw: tuple[int, int] | None = None,
    limit: int | None = None,
    decode_threads: int = 4,
    process_index: int | None = None,
    process_count: int | None = None,
    barrier_timeout_s: float | None = None,
) -> StreamResult:
    """Resumable streaming extraction straight from a directory of
    per-object h5 files (README contract, README.md:5-14) on ``device``: the
    h5 adapter decodes/packs/quantises shards on a background thread while
    the device reduces the previous shard (``decode_threads`` parallelises
    the per-object h5 reads inside each shard fetch). Multi-process runs
    split the shard ranges per process (see ``stream_extract``): each
    process opens and decodes only its own objects' h5 files."""
    from tpumcia_torch.io.h5 import h5_stream_source

    if mesh is None:
        require_device(device, "stream_extract_h5")
    cfg = config or FeatureConfig()
    src = h5_stream_source(
        source,
        target_hw=target_hw,
        quantize_levels=cfg.glcm.levels,
        limit=limit,
        decode_threads=decode_threads,
    )
    return stream_extract(
        src.fetch,
        len(src),
        out_dir,
        device=device,
        shard_size=shard_size,
        config=cfg,
        config_tag=config_tag,
        mesh=mesh,
        prefetch_depth=prefetch_depth,
        process_index=process_index,
        process_count=process_count,
        barrier_timeout_s=barrier_timeout_s,
        # the h5 contract's 'channels' key (README.md:13) names the columns
        channel_names=src.channels,
    )


def load_feature_shards(
    out_dir: str | Path,
    *,
    names: list[str] | None = None,
    config: FeatureConfig | None = None,
    channel_names: list[str] | None = None,
) -> tuple[FeatureMatrix, np.ndarray | None]:
    """Reassemble the full feature matrix (ordered by object index) from a
    shard directory (all processes' manifests merged).

    Pass the ``config`` the shards were extracted with: the returned
    matrix's ``channel_columns()`` grouping is derived from it, so a
    default config against multi-offset / morphology shards would silently
    misgroup the per-channel column blocks (the same defect class
    ``FeatureMatrix.save``/``load`` guards against)."""
    out_dir = Path(out_dir)
    manifest = _load_merged_manifest(out_dir)
    entries = sorted(
        (e for e in manifest["shards"].values() if e["status"] == "done"),
        key=lambda e: e["start"],
    )
    if not entries:
        raise FileNotFoundError(f"no completed shards in {out_dir}")
    vals, degs, labels, have_labels = [], [], [], True
    for e in entries:
        with np.load(out_dir / e["file"]) as z:
            vals.append(z["values"])
            degs.append(z["degenerate"])
            if "labels" in z:
                labels.append(z["labels"])
            else:
                have_labels = False
    values = np.concatenate(vals)
    degenerate = np.concatenate(degs)
    C = degenerate.shape[1]
    if config is None:
        config = FeatureConfig()
    if names is None:
        names = _config_feature_names(config, C, channel_names)
    fm = FeatureMatrix(
        values=values,
        names=list(names),
        num_channels=C,
        degenerate=degenerate,
        config=config,
        channel_names=channel_names,
    )
    return fm, (np.concatenate(labels) if have_labels and labels else None)
