"""Multi-process pipeline walkthrough (the port's
``examples/multihost_pipeline.py``).

Every process calls ``init_distributed``, builds ONE mesh over every rank's
devices, contributes its local rows to one global batch
(``shard_across_processes``) and runs the same sharded entry points as a
single process: the sharded GLCM statistics, the collective MinMax fit, the
permutation sweep, data-parallel CNN training (``fit_cnn(mesh=)``) and
``stream_extract(mesh=)``.

Without ``--worker`` it launches two local ranks over gloo through a
``file://`` store (the same simulation the tests use; on a card both ranks
share it, which NCCL does not allow) and waits for both:

    python -m tpumcia_torch.examples.multihost_pipeline
    python -m tpumcia_torch.examples.multihost_pipeline --tiny --device cpu

On several hosts run one ``--worker`` per card, with torchrun's variables
or ``TPUMCIA_COORDINATOR`` / ``TPUMCIA_NUM_PROCESSES`` /
``TPUMCIA_PROCESS_ID`` (``launch_eval.sh``'s):

    torchrun --nproc-per-node 4 -m tpumcia_torch.examples.multihost_pipeline --worker
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from tpumcia_torch.examples import device_of, parser

WORKER_TIMEOUT_S = 600
REPO = Path(__file__).resolve().parents[2]


def worker(args, device) -> None:
    import torch

    from tpumcia_torch.config import FeatureConfig, HeadConfig
    from tpumcia_torch.features.finalize import finalize_features
    from tpumcia_torch.models.heads import fit_head
    from tpumcia_torch.models.train import CNNConfig, fit_cnn
    from tpumcia_torch.parallel import (
        fit_scaler_sharded, init_distributed, make_mesh, permutation_importance_sharded,
        process_summary, shard_across_processes, sufficient_stats_sharded,
    )
    from tpumcia_torch.parallel.distributed import barrier
    from tpumcia_torch.pipeline.streaming import stream_extract

    # 1. one process group over every process (environment-configured)
    init_distributed(backend=args.backend)
    info = process_summary()
    pid = info["process_index"]
    print(f"[proc {pid}] topology: {info}")
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh(devices=device)  # every rank's devices

    # 2. per-process local rows -> one global batch (every process makes
    #    its slice of one seeded dataset; a real deployment loads its own
    #    h5 shard)
    rng = np.random.RandomState(0)
    B = 4 * mesh.shape["data"]
    full = (rng.random((B, 16, 16, 3)) * 256).astype(np.uint8)
    half = B // info["process_count"]
    X = shard_across_processes(full[pid * half:(pid + 1) * half], mesh)

    # 3. the same sharded entry points as a single process
    stats = sufficient_stats_sharded(X, mesh=mesh)  # every rank gets every row
    done = finalize_features(stats, backend="host")
    print(f"[proc {pid}] features: {done.values.shape}")

    Xf = np.nan_to_num(done.values).astype(np.float32)
    y = (np.arange(B) % 2).astype(np.int32)
    scaler = fit_scaler_sharded(Xf, mesh=mesh)  # MIN/MAX all-reduces
    Xs = scaler.transform(torch.from_numpy(Xf).to(mesh.first_device)).cpu().numpy()
    head = fit_head(Xs, y, device=mesh.first_device, config=HeadConfig(kind="logistic", num_steps=50))
    sweep = permutation_importance_sharded(head, Xs, y, mesh=mesh, n_repeats=3, seed=42)
    print(f"[proc {pid}] sweep importances shape: {sweep.importances.shape}")

    # 4. data-parallel CNN training over the same mesh (the same dataset on
    #    every process; the batch split over 'data', the gradients summed)
    cnn = fit_cnn(
        full.astype(np.float32) / 255.0, y, device=device, mesh=mesh,
        config=CNNConfig(num_classes=2, width=8, depth="10" if args.tiny else "18", epochs=1, batch_size=8),
    )
    print(f"[proc {pid}] cnn loss history: {cnn.history}")

    # 5. streaming over the mesh: every rank computes its slots' rows of
    #    every shard, rank 0 writes the shards and the manifest
    out_dir = Path(args.work_dir or tempfile.gettempdir()) / "tpumcia_torch_multihost_stream"
    # resume is keyed on (shard start, config tag): a previous run's shards
    # would be skipped and mixed in, so rank 0 clears the directory first
    if pid == 0 and out_dir.exists():
        import shutil

        shutil.rmtree(out_dir)
    barrier()

    def fetch(idx):
        return full[idx], None, y[idx]

    stream = stream_extract(fetch, len(full), out_dir, device=device, shard_size=max(4, len(full) // 4),
                            config=FeatureConfig(), config_tag="multihost-demo", mesh=mesh)
    print(f"[proc {pid}] streamed {stream.features.shape} "
          f"(computed {stream.shards_computed} shards, profile {stream.profile})")
    print(f"[proc {pid}] OK")


def launch_local_demo(args) -> None:
    """Two local ranks over gloo, a ``file://`` store in a temporary
    directory; every rank is killed if one fails or the time runs out."""
    with tempfile.TemporaryDirectory(prefix="tpumcia_multihost_") as tmp:
        env = dict(os.environ, TPUMCIA_COORDINATOR=f"file://{tmp}/store", TPUMCIA_NUM_PROCESSES="2",
                   PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
        for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
            env.pop(k, None)
        cmd = [sys.executable, "-m", "tpumcia_torch.examples.multihost_pipeline", "--worker",
               "--backend", "gloo", "--device", args.device, "--work-dir", tmp] + (["--tiny"] if args.tiny else [])
        logs = [Path(tmp) / f"worker{pid}.log" for pid in range(2)]
        outs = [log.open("w") for log in logs]
        procs = [subprocess.Popen(cmd, env={**env, "TPUMCIA_PROCESS_ID": str(pid)}, cwd=REPO,
                                  stdout=out, stderr=subprocess.STDOUT) for pid, out in enumerate(outs)]
        deadline = time.monotonic() + WORKER_TIMEOUT_S
        codes = []
        try:
            for p in procs:
                try:
                    codes.append(p.wait(timeout=max(1.0, deadline - time.monotonic())))
                except subprocess.TimeoutExpired:
                    codes.append(f"no exit in {WORKER_TIMEOUT_S} s")
        finally:
            for p, out in zip(procs, outs):
                if p.poll() is None:
                    p.kill()
                    p.wait()
                out.close()
        for log in logs:  # each worker's lines together, in rank order
            print(log.read_text(), end="", flush=True)
    if any(codes):
        raise SystemExit(f"worker exit codes: {codes}")
    print("multihost demo finished: both workers OK")


def main(argv=None) -> int:
    p = parser(__doc__)
    p.add_argument("--worker", action="store_true", help="run one rank (the topology from the environment)")
    p.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                   help="the process group's backend (default: NCCL on a card, gloo on the CPU)")
    p.add_argument("--work-dir", default=None, help="where a worker writes its stream directory")
    args = p.parse_args(argv)
    device = device_of(p, args)
    if args.worker:
        worker(args, device)
    else:
        launch_local_demo(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
