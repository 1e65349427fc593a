"""One rank of a multi-process check run of the sharded feature path or,
with ``--mode cnn``, of the CNN path (the port's counterpart of
``__graft_entry__.dryrun_multichip``).

    python -m tpumcia_torch.parallel.dryrun --world 2 --rank 0 --store /tmp/run/store \\
        --backend gloo --device cpu --objects 64 --out /tmp/run/rank0.json
    python -m tpumcia_torch.parallel.dryrun --mode cnn --size tiny --world 2 --rank 0 \\
        --store /tmp/run/store --backend gloo --device cpu --out /tmp/run/rank0.json

Start one process per rank with the same ``--store`` (a ``file://``
rendezvous) and ``--world``. Every rank makes the same cytometry-shaped
objects from one seed (12 channels, 48x48, 256 levels, a cell mask) and runs,
over a mesh of every rank's ``--slots`` slots: the sharded statistics (whole
batch and a :class:`ShardedRows` feed), ``extract_features(mesh=)``, the
collective scaler, the channel sweeps of a logistic and of a forest head,
``run_pipeline`` with ``MeshConfig(data=-1)``, ``stream_extract`` with the
split across processes that it detects (its shards written round-robin,
then a collective barrier) and ``stream_extract(mesh=)`` (every shard over
the mesh, rank 0 writing). Rank 0 writes the results, digests of every
array, the kernel launches of every rank and the seconds to ``--out``.

:func:`reference` computes the same results in one process on one device,
through the unsharded calls, and :func:`mismatches` names where a rank's
results differ from them: a run is right when it names nothing.

The CNN mode trains ``fit_cnn(mesh=)`` over every rank's ``--slots`` slots
on seeded synthetic images of one of :data:`CNN_SIZES`, then runs
``predict_logits`` and the three occlusion probes over the same mesh. Every
rank's record (the loss history, a digest of the final ``state_dict``, the
logits' digest, the probes' drops, its seconds by step) goes into rank 0's
``--out``. After the gradient all-reduce every rank holds the same weights,
so the records are equal; :func:`reference_cnn` is the same run in one
process over as many slots on one device, equal to them bit for bit where
each slot's block runs the same kernels (one CPU thread; cuDNN with
``deterministic`` set, which the CNN mode sets on a CUDA device).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

HW, CHANNELS, SIGNAL = 48, 12, 4
HEAD_STEPS = 300
FOREST_TREES = 10
SWEEP_REPEATS = 5

# the CNN mode's sizes: ``tiny`` for the CPU tests, ``full`` for the card
# (ResNet-18 at width 64; 24 steps at batch 256, enough to learn the signal
# channel, so that the probes' drops are not all zero)
CNN_SIZES = {
    "tiny": {"images": 96, "hw": 16, "width": 8, "depth": "10", "epochs": 2, "batch_size": 16,
             "learning_rate": 3e-3},
    "full": {"images": 2048, "hw": 64, "width": 64, "depth": "18", "epochs": 3, "batch_size": 256,
             "learning_rate": 1e-3},
}
CNN_CLASSES = 4
CNN_PROBE_ROWS = 512  # the probes' rows (the first ones)
CNN_MAP_ROWS = 16  # occlusion_map's images
CNN_REPEATS = 2


def make_objects(n: int, seed: int = 0):
    """Imaging-flow-cytometry-like objects (BASELINE config 4, as
    ``examples/cytometry_h5.py`` shapes them): uint16 background
    U[200, 1500), a cell disk of radius U(10, 16) centred in [0.35, 0.65] of
    the frame, signal on channel ``SIGNAL`` only (activated:
    exp(-r/8)*38000, resting: disk*6000), quantized to 256 levels (v >> 8).
    Returns (uint8 (n, 48, 48, 12) levels, the shared cell mask, labels
    (i // 8) % 2, donors "donor{i % 8}")."""
    rng = np.random.default_rng(seed)
    img = rng.integers(200, 1500, size=(n, HW, HW, CHANNELS)).astype(np.uint16)
    cy, cx = rng.uniform(HW * 0.35, HW * 0.65, size=(2, n, 1, 1))
    yy, xx = np.mgrid[:HW, :HW]
    r = np.hypot(yy[None] - cy, xx[None] - cx)
    cell = r < rng.uniform(10, 16, size=(n, 1, 1))
    labels = (np.arange(n) // 8) % 2
    boost = np.where(labels[:, None, None] == 0, np.exp(-r / 8) * 38000, cell * 6000.0).astype(np.uint16)
    img[..., SIGNAL] = np.clip(img[..., SIGNAL].astype(np.int64) + boost, 0, 65535).astype(np.uint16)
    donors = np.array([f"donor{i % 8}" for i in range(n)])
    return (img >> 8).astype(np.uint8), cell, labels, donors


def pipeline_config(mesh_data: int) -> dict:
    return {
        "head": {"kind": "logistic", "num_steps": HEAD_STEPS},
        "split": {"test_size": 0.25, "seed": 0, "group_by": "donor"},
        "mesh": {"data": mesh_data},
        "fast_path": "auto" if mesh_data != 1 else "never",
    }


def digest(x) -> str:
    """sha256 of an array's or a tensor's bytes, dtype and shape."""
    a = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.ascontiguousarray(x)
    return hashlib.sha256(f"{a.dtype}{a.shape}".encode() + a.tobytes()).hexdigest()


def stats_digests(stats) -> dict:
    return {f: digest(getattr(stats, f)) for f in stats._fields if getattr(stats, f) is not None}


def _launches() -> dict:
    from tpumcia_torch.features import cuda_glcm

    counts = dict(cuda_glcm.LAUNCHES_BY_FORM)
    cuda_glcm.reset_launch_counts()
    return counts


def _heads_and_sweeps(X, labels, donors, device, sweep):
    """The logistic and forest heads on ``device`` from the donor split of
    ``X``, and each head's channel sweep on the test rows by ``sweep``."""
    import tpumcia_torch as tt
    from tpumcia_torch.features import registry
    from tpumcia_torch.utils.split import train_test_split_indices

    split = train_test_split_indices(len(X), test_size=0.25, seed=0, groups=donors)
    groups = registry.columns_by_channel_positional(CHANNELS)
    out = {}
    for kind, cfg in (("logistic", tt.HeadConfig(kind="logistic", num_steps=HEAD_STEPS)),
                      ("forest", tt.HeadConfig(kind="random_forest", n_estimators=FOREST_TREES))):
        head = tt.fit_head(X[split.train_idx], labels[split.train_idx], device=device, config=cfg)
        res = sweep(head, X[split.test_idx], labels[split.test_idx], groups)
        out[kind] = {"importances": digest(res.importances), "mean": res.importances_mean.tolist(),
                     "baseline": res.baseline_score}
    return out


def _pipeline_record(res) -> dict:
    return {
        "features": digest(res.features.values), "test_idx": digest(res.test_idx),
        "test_accuracy": res.test_accuracy,
        "ranking": res.channel_result.ranking.tolist(),
        "channel_totals": np.asarray(res.channel_result.total).tolist(),
        "feature_ranking": res.feature_result.ranking.tolist(),
    }


def _fetcher(images, mask, labels):
    return lambda idx: (images[idx], mask[idx], labels[idx])


def cnn_data(size: str):
    """Seeded (images float32 (N, hw, hw, 3) in [0, 1], labels) for the CNN
    mode: the port's ``synthetic_multichannel`` drawn on the CPU, so every
    rank and the reference hold the same images."""
    from tpumcia_torch.io.synthetic import synthetic_multichannel

    sz = CNN_SIZES[size]
    images, labels, _ = synthetic_multichannel(
        sz["images"] // CNN_CLASSES, num_classes=CNN_CLASSES, hw=sz["hw"], seed=3, device="cpu")
    return images.astype(np.float32) / 255.0, labels


def cnn_config(size: str):
    from tpumcia_torch.models.train import CNNConfig

    sz = CNN_SIZES[size]
    return CNNConfig(num_classes=CNN_CLASSES, width=sz["width"], depth=sz["depth"],
                     epochs=sz["epochs"], batch_size=sz["batch_size"], learning_rate=sz["learning_rate"])


def state_digest(model) -> str:
    """sha256 over every tensor of a ``state_dict``, in order, with its name."""
    h = hashlib.sha256()
    for name, t in model.state_dict().items():
        h.update(name.encode() + digest(t).encode())
    return h.hexdigest()


def cnn_steps(size: str, device, mesh, step) -> dict:
    """``fit_cnn`` over ``mesh`` on the CNN mode's data, then
    ``predict_logits`` and the three probes over the same mesh, each through
    ``step(name, fn)``; returns the record (no seconds)."""
    from tpumcia_torch.importance import occlusion
    from tpumcia_torch.models.train import fit_cnn

    images, labels = cnn_data(size)
    x, y = images[:CNN_PROBE_ROWS], labels[:CNN_PROBE_ROWS]
    head = step("fit", lambda: fit_cnn(images, labels, device=device, config=cnn_config(size), mesh=mesh))
    return {
        "history": [h["loss"] for h in head.history],
        "state": state_digest(head.model),
        "logits": step("logits", lambda: digest(head.predict_logits(x))),
        "occlusion": step("occlusion", lambda: occlusion.channel_occlusion_importance(head, x, y).tolist()),
        "permutation": step("permutation", lambda: occlusion.channel_permutation_importance_images(
            head, x, y, n_repeats=CNN_REPEATS, seed=42).tolist()),
        "map": step("map", lambda: digest(occlusion.occlusion_map(
            head, x[:CNN_MAP_ROWS], y[:CNN_MAP_ROWS], window=8, stride=8))),
    }


def _cnn_determinism(device) -> None:
    """One thread on the CPU; cuDNN's deterministic algorithms on a card
    (the same kernels for the same block shapes in every process)."""
    if device.type == "cuda":
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    else:
        torch.set_num_threads(1)


def reference_cnn(size: str, device, slots: int) -> dict:
    """The CNN mode's record from one process over ``slots`` slots on
    ``device`` (cuDNN's flags restored afterwards)."""
    from tpumcia_torch.parallel import make_mesh

    device = torch.device(device)
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    try:
        _cnn_determinism(device)
        return cnn_steps(size, device, make_mesh(devices=[device] * slots), lambda name, fn: fn())
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags


def cnn_mismatches(rank0_record: dict, ref: dict) -> list[str]:
    """Where the ranks' CNN records differ from each other or from
    :func:`reference_cnn`'s; empty when they are all equal."""
    ranks = rank0_record["ranks"]
    bad = [f"rank {r} {k}" for r, rec in enumerate(ranks) for k in ref if rec.get(k) != ref[k]]
    return bad + [f"rank {r} differs from rank 0" for r, rec in enumerate(ranks)
                  if {k: rec.get(k) for k in ref} != {k: ranks[0].get(k) for k in ref}]


def run_cnn_rank(args, device, t_start, t_joined) -> dict:
    """This rank's part of the CNN check run; rank 0's record carries every
    rank's."""
    import torch.distributed as dist

    from tpumcia_torch.parallel import make_mesh, process_summary
    from tpumcia_torch.parallel.distributed import backend_of, barrier

    _cnn_determinism(device)
    mesh = make_mesh(devices=[device] * args.slots)
    secs = {"rendezvous": t_joined - t_start}

    def step(name, fn):
        t0 = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        secs[name] = time.perf_counter() - t0
        return out

    rec = cnn_steps(args.size, device, mesh, step)
    rec["seconds"] = secs
    out = {"summary": process_summary(), "size": args.size,
           "mesh": {"data": mesh.shape["data"], "slots": [(r, str(d)) for r, d in mesh.slots],
                    "backend": backend_of(mesh.group)}}
    out["ranks"] = [None] * dist.get_world_size()
    dist.all_gather_object(out["ranks"], rec)
    barrier()
    dist.destroy_process_group()
    out["seconds"] = {"total": time.perf_counter() - t_start}
    return out


def run_rank(args) -> dict:
    """This rank's part of the check run; every rank returns its record,
    rank 0's carries every rank's launches."""
    import torch.distributed as dist

    import tpumcia_torch as tt
    from tpumcia_torch.features.extract import extract_features
    from tpumcia_torch.parallel import (
        fit_scaler_sharded, init_distributed, make_mesh, permutation_importance_sharded,
        process_summary, shard_across_processes, sufficient_stats_sharded,
    )
    from tpumcia_torch.parallel.distributed import backend_of, barrier
    from tpumcia_torch.parallel.mesh import split_rows
    from tpumcia_torch.pipeline.streaming import stream_extract

    t_start = time.perf_counter()
    init_distributed(
        f"file://{Path(args.store).resolve()}", args.world, args.rank,
        local_device_ids=[0] if args.device == "cuda" else None,
        backend=args.backend, timeout_s=args.timeout,
    )
    t_joined = time.perf_counter()
    if args.device == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        torch.set_num_threads(1)  # the reference's CPU numbers come from one thread
        device = torch.device("cpu")
    if args.mode == "cnn":
        return run_cnn_rank(args, device, t_start, t_joined)
    pool = [device] * args.slots
    images, mask, labels, donors = make_objects(args.objects)
    mesh = make_mesh(devices=pool)
    rec, launches, secs = {"summary": process_summary()}, {}, {}
    _launches()

    def step(name, fn):
        t0 = time.perf_counter()
        rec[name] = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        secs[name] = time.perf_counter() - t0
        launches[name] = _launches()

    step("stats", lambda: stats_digests(
        sufficient_stats_sharded(images, mask, mesh=mesh, need_diff_hist=False)))
    a, b = split_rows(len(images), args.world)[args.rank]
    step("stats_rows", lambda: stats_digests(sufficient_stats_sharded(
        shard_across_processes(images[a:b], mesh), shard_across_processes(mask[a:b], mesh),
        mesh=mesh, need_diff_hist=False)))
    values = []

    def features():
        values.append(extract_features(images, mask, device=device, mesh=mesh).values)
        return digest(values[0])

    step("features", features)
    X = np.nan_to_num(np.asarray(values[0], np.float32))

    def scaler():
        s = fit_scaler_sharded(X, mesh=mesh)
        return {"min": digest(s.data_min), "max": digest(s.data_max)}

    step("scaler", scaler)
    step("sweeps", lambda: _heads_and_sweeps(
        X, labels, donors, device,
        lambda head, Xt, yt, groups: permutation_importance_sharded(
            head, Xt, yt, mesh=mesh, n_repeats=SWEEP_REPEATS, seed=42, groups=groups)))
    step("pipeline", lambda: _pipeline_record(tt.run_pipeline(
        images, labels, mask=mask, groups=donors, device=pool, config=pipeline_config(-1))))
    stream_dir = Path(args.store).resolve().parent / "stream"
    step("stream", lambda: {"features": digest(stream_extract(
        _fetcher(images, mask, labels), len(images), stream_dir, device=device,
        shard_size=max(1, len(images) // 8)).features.values)})
    mesh_dir = stream_dir.with_name("stream_mesh")
    step("stream_mesh", lambda: {"features": digest(stream_extract(
        _fetcher(images, mask, labels), len(images), mesh_dir, device=device,
        shard_size=max(1, len(images) // 8), mesh=mesh).features.values)})
    rec["mesh"] = {"data": mesh.shape["data"], "slots": [(r, str(d)) for r, d in mesh.slots],
                   "backend": backend_of(mesh.group)}
    rec["launches"], rec["seconds"] = launches, secs
    rec["seconds"]["rendezvous"] = t_joined - t_start
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, {"launches": launches, "seconds": secs})
    rec["ranks"] = everyone
    if args.rank == 0:
        rec["stream_manifests"], rec["stream_mesh_manifests"] = ({
            p.name: sorted(json.loads(p.read_text())["shards"]) for p in sorted(d.glob("manifest*.json"))
        } for d in (stream_dir, mesh_dir))
    barrier()
    dist.destroy_process_group()
    rec["seconds"]["total"] = time.perf_counter() - t_start
    return rec


def reference(n: int, device, stream_dir) -> dict:
    """The results a rank reports, from the unsharded calls in this process
    on ``device``."""
    import tpumcia_torch as tt
    from tpumcia_torch.features import cuda_glcm
    from tpumcia_torch.features.extract import _chw_levels, extract_features
    from tpumcia_torch.features.stats import prepare_mask
    from tpumcia_torch.importance.permutation import permutation_importance
    from tpumcia_torch.models.scaler import MinMaxScaler
    from tpumcia_torch.pipeline.streaming import stream_extract

    device = torch.device(device)
    images, mask, labels, donors = make_objects(n)
    stats = stats_digests(cuda_glcm.sufficient_stats(
        _chw_levels(torch.from_numpy(images).to(device)), prepare_mask(mask, images.shape, device),
        levels=256, offset=(0, 5)))
    fm = extract_features(images, mask, device=device)
    X = np.nan_to_num(np.asarray(fm.values, np.float32))
    s = MinMaxScaler.fit(torch.from_numpy(X).to(device))
    sweeps = _heads_and_sweeps(
        X, labels, donors, device,
        lambda head, Xt, yt, groups: permutation_importance(
            head, Xt, yt, n_repeats=SWEEP_REPEATS, seed=42, groups=groups))
    pipe = tt.run_pipeline(images, labels, mask=mask, groups=donors, device=device,
                           config=pipeline_config(1))
    streamed = stream_extract(_fetcher(images, mask, labels), n, stream_dir, device=device,
                              shard_size=max(1, n // 8))
    return {
        "stats": stats, "stats_rows": stats, "features": digest(fm.values),
        "scaler": {"min": digest(s.data_min), "max": digest(s.data_max)},
        "sweeps": sweeps, "pipeline": _pipeline_record(pipe),
        "stream": {"features": digest(streamed.features.values)},
        "stream_mesh": {"features": digest(streamed.features.values)},
    }


def mismatches(rank_record: dict, ref: dict, n: int) -> list[str]:
    """Where a rank's record differs from :func:`reference`'s, and whether
    its stream directories hold every shard once (the mesh's in the one
    manifest rank 0 writes); empty when it is right."""
    bad = [k for k in ref if rank_record.get(k) != ref[k]]
    want = [f"shard_{s:09d}" for s in range(0, n, max(1, n // 8))]
    for key in ("stream_manifests", "stream_mesh_manifests"):
        manifests = rank_record.get(key, {})
        shards = sorted(sid for sids in manifests.values() for sid in sids)
        if shards != want or (key == "stream_mesh_manifests" and list(manifests) != ["manifest.json"]):
            bad.append(f"{key} {manifests} != {want}")
    return bad


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--mode", choices=("features", "cnn"), default="features")
    p.add_argument("--size", choices=tuple(CNN_SIZES), default="tiny", help="the CNN mode's size")
    p.add_argument("--world", type=int, required=True, help="number of ranks")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--store", required=True, help="rendezvous file, the same for every rank")
    p.add_argument("--backend", choices=("gloo", "nccl"), required=True)
    p.add_argument("--device", choices=("cpu", "cuda"), required=True)
    p.add_argument("--objects", type=int, default=4096)
    p.add_argument("--slots", type=int, default=1, help="data slots of this rank")
    p.add_argument("--timeout", type=float, default=60.0, help="rendezvous and collective timeout (s)")
    p.add_argument("--out", required=True, help="rank 0's JSON record")
    args = p.parse_args(argv)
    rec = run_rank(args)
    if args.rank == 0:
        Path(args.out).write_text(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
