"""The port across processes (``tpumcia_torch.parallel.distributed``) on
the CPU: ``init_distributed``'s topology rules (the counterpart of
``tests/test_distributed.py``'s single-process tests), two gloo ranks of
``python -m tpumcia_torch.parallel.dryrun`` held against the same calls in
this process on one device, two gloo ranks of its CNN mode
(``fit_cnn(mesh=)`` and the probes) held against each other and against
this process's two-slot run, and ``CNNHead.save`` over a two-rank mesh.

The children import torch and the port only (no jax). Each rendezvous goes
through a ``file://`` store under the test's own directory (no port to
collide with under several pytest workers) with a 60 s timeout, and each
child runs under a subprocess timeout that kills every rank and fails the
test, so a hung rank cannot hold up the suite. Tolerances: none; rank 0's
digests (statistics, features, scaler, sweeps, the pipeline's features and
split) equal the one-process run's bit for bit, its accuracy and rankings
are equal, and the stream directory holds every shard once. The CNN ranks'
loss histories, final weights, logits and probe drops equal each other and
this process's two-slot run bit for bit: every process runs torch on one
thread (the children ``torch.set_num_threads(1)``, this one through
``torch_parity``), so each 8-row block runs the same oneDNN kernels in every
process, and the all-reduce of two ranks adds the same two numbers as one
replica's accumulation of its two slots.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_parity import to_chw_tensor
from tpumcia_torch.parallel import dryrun
from tpumcia_torch.parallel.distributed import ShardedRows, init_distributed, shard_across_processes

REPO = Path(__file__).resolve().parents[1]
CHILD_TIMEOUT_S = 120
TOPOLOGY_VARS = ("TPUMCIA_COORDINATOR", "TPUMCIA_NUM_PROCESSES", "TPUMCIA_PROCESS_ID",
                 "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


@pytest.fixture
def no_topology(monkeypatch):
    for k in TOPOLOGY_VARS:
        monkeypatch.delenv(k, raising=False)


def _child_env(**extra):
    env = {k: v for k, v in os.environ.items() if k not in TOPOLOGY_VARS}
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "1"
    env.update(extra)
    return env


def _run_children(cmds, env=None):
    """Start every command at once, wait for all with one deadline, kill
    every child that is left; returns [(rc, output)]."""
    procs = [subprocess.Popen(c, cwd=REPO, env=env or _child_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for c in cmds]
    deadline = time.monotonic() + CHILD_TIMEOUT_S
    out = []
    try:
        for p in procs:
            text, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            out.append((p.returncode, text))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def test_single_process_without_a_coordinator(no_topology):
    assert init_distributed() is False


@pytest.mark.parametrize("kw", [dict(num_processes=4, process_id=0), dict(process_id=1), dict(num_processes=2)])
def test_partial_topology_raises(no_topology, kw):
    """tpumcia's rule: an explicit num_processes/process_id without a
    coordinator raises rather than degrade to one process."""
    with pytest.raises(ValueError, match="coordinator"):
        init_distributed(**kw)


def test_partial_topology_from_the_environment_raises(no_topology, monkeypatch):
    monkeypatch.setenv("TPUMCIA_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="coordinator"):
        init_distributed()
    monkeypatch.setenv("TPUMCIA_COORDINATOR", "127.0.0.1:1")
    monkeypatch.delenv("TPUMCIA_NUM_PROCESSES")
    with pytest.raises(ValueError, match="needs both num_processes and process_id"):
        init_distributed()


_TOPOLOGY_CHILD = """
import json, torch.distributed as dist
from tpumcia_torch.parallel.distributed import init_distributed, process_summary
multi = init_distributed()
again = init_distributed()
print(json.dumps({"multi": multi, "again": again, "world": dist.get_world_size(), **process_summary()}))
dist.destroy_process_group()
"""


@pytest.mark.parametrize("launcher", ["tpumcia", "torchrun"])
def test_environment_topology_is_picked_up(launcher, tmp_path):
    """``TPUMCIA_*`` (as launch_eval.sh sets them) and torchrun's variables
    each form a group; a second call is a no-op; one rank is not multi."""
    if launcher == "tpumcia":
        env = _child_env(TPUMCIA_COORDINATOR=f"file://{tmp_path}/store", TPUMCIA_NUM_PROCESSES="1",
                         TPUMCIA_PROCESS_ID="0")
    else:
        import socket

        with socket.socket() as s:  # a free local port for the TCP store
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        env = _child_env(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="1", RANK="0",
                         LOCAL_RANK="0")
    [(rc, text)] = _run_children([[sys.executable, "-c", _TOPOLOGY_CHILD]], env)
    assert rc == 0, text
    info = json.loads(text.strip().splitlines()[-1])
    assert info["multi"] is False and info["again"] is False and info["world"] == 1
    assert info["process_index"] == 0 and info["process_count"] == 1
    assert info["backend"] == "gloo"  # this host has no CUDA


def test_a_rank_without_its_peer_raises_within_its_timeout(tmp_path):
    """Rank 0 of 2 with no rank 1: the rendezvous times out and the worker
    exits non-zero, it does not hang or fall back to one process."""
    [(rc, text)] = _run_children([[
        sys.executable, "-m", "tpumcia_torch.parallel.dryrun", "--world", "2", "--rank", "0",
        "--store", str(tmp_path / "store"), "--backend", "gloo", "--device", "cpu",
        "--objects", "16", "--timeout", "3", "--out", str(tmp_path / "out.json"),
    ]])
    assert rc != 0, text
    assert not (tmp_path / "out.json").exists()


def test_shard_across_processes_single_process():
    """One process: its rows are the whole batch, and the sharded
    statistics take the tagged block as they take the batch."""
    from tpumcia_torch.features import cuda_glcm
    from tpumcia_torch.parallel import make_mesh, sufficient_stats_sharded

    mesh = make_mesh(devices=["cpu"] * 3)
    x = (np.random.default_rng(0).random((7, 16, 16, 2)) * 256).astype(np.uint8)
    rows = shard_across_processes(x, mesh)
    assert isinstance(rows, ShardedRows) and rows.rows is x and (rows.offset, rows.total) == (0, 7)
    got = sufficient_stats_sharded(rows, mesh=mesh, need_diff_hist=False)
    want = cuda_glcm.sufficient_stats(to_chw_tensor(x), levels=256, offset=(0, 5))
    for f in got._fields:
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if g is not None:
            assert torch.equal(g, w), f


N_OBJECTS = 64


def test_two_gloo_ranks_match_one_process(tmp_path):
    """Two ranks over gloo on the CPU, one slot each: rank 0's statistics
    (whole batch and ShardedRows feed), features, scaler, both sweeps,
    ``run_pipeline`` over ``MeshConfig(data=-1)`` and the ``stream_extract``
    directory (split across the ranks, a collective barrier) equal the same
    calls in this process on one device."""
    cmds = [[sys.executable, "-m", "tpumcia_torch.parallel.dryrun", "--world", "2", "--rank", str(r),
             "--store", str(tmp_path / "store"), "--backend", "gloo", "--device", "cpu",
             "--objects", str(N_OBJECTS), "--out", str(tmp_path / "rank0.json")] for r in (0, 1)]
    results = _run_children(cmds)
    for r, (rc, text) in enumerate(results):
        assert rc == 0, f"rank {r}:\n{text}"
    got = json.loads((tmp_path / "rank0.json").read_text())
    assert got["mesh"]["data"] == 2 and got["mesh"]["backend"] == "gloo"
    assert [r for r, _ in got["mesh"]["slots"]] == [0, 1]
    assert got["summary"]["process_count"] == 2 and len(got["ranks"]) == 2
    assert sorted(got["stream_manifests"]) == ["manifest_p0000.json", "manifest_p0001.json"]
    ref = dryrun.reference(N_OBJECTS, "cpu", tmp_path / "one_process_stream")
    assert dryrun.mismatches(got, ref, N_OBJECTS) == []
    assert got["pipeline"]["ranking"][0] == dryrun.SIGNAL
    assert got["pipeline"]["test_accuracy"] >= 0.95


def test_two_gloo_ranks_of_the_cnn_match_one_process_two_slots(tmp_path):
    """``--mode cnn --size tiny``: both ranks' records equal each other and
    :func:`dryrun.reference_cnn` over two slots in this process."""
    cmds = [[sys.executable, "-m", "tpumcia_torch.parallel.dryrun", "--mode", "cnn", "--size", "tiny",
             "--world", "2", "--rank", str(r), "--store", str(tmp_path / "store"), "--backend", "gloo",
             "--device", "cpu", "--out", str(tmp_path / "rank0.json")] for r in (0, 1)]
    results = _run_children(cmds)
    for r, (rc, text) in enumerate(results):
        assert rc == 0, f"rank {r}:\n{text}"
    got = json.loads((tmp_path / "rank0.json").read_text())
    assert got["mesh"]["data"] == 2 and got["mesh"]["backend"] == "gloo" and len(got["ranks"]) == 2
    assert got["summary"]["process_count"] == 2
    ref = dryrun.reference_cnn("tiny", "cpu", slots=2)
    assert dryrun.cnn_mismatches(got, ref) == []
    assert len(ref["history"]) == dryrun.CNN_SIZES["tiny"]["epochs"] and ref["occlusion"][0] > 0
    assert set(got["ranks"][1]["seconds"]) == {"rendezvous", "fit", "logits", "occlusion", "permutation", "map"}
    # the check would see a difference: one slot trains other weights
    assert dryrun.cnn_mismatches(got, dryrun.reference_cnn("tiny", "cpu", slots=1)) != []


_SAVE_CHILD = """
import json, sys
import numpy as np, torch, torch.distributed as dist
from tpumcia_torch.models import cnn, train
from tpumcia_torch.parallel import init_distributed, make_mesh
store, rank, path = sys.argv[1], int(sys.argv[2]), sys.argv[3]
init_distributed(f"file://{store}", 2, rank, backend="gloo", timeout_s=60)
writes = []
real_save = torch.save
torch.save = lambda *a, **k: (writes.append(1), real_save(*a, **k))
model = cnn.make_resnet(3, in_channels=2, width=8, depth="10")
cnn.init_parameters(model, torch.Generator().manual_seed(4))
cfg = train.CNNConfig(num_classes=3, width=8, depth="10")
head = train.CNNHead(model=model, classes=np.array([0, 1, 2]), config=cfg, mesh=make_mesh(devices="cpu"))
head.save(path)
back = train.CNNHead.load(path, device="cpu")  # every rank reads it after the barrier
same = all(torch.equal(a, b) for a, b in zip(back.model.state_dict().values(), model.state_dict().values()))
print(json.dumps({"rank": rank, "writes": len(writes), "same": same}))
dist.destroy_process_group()
"""


def test_cnn_head_save_over_two_ranks_writes_once(tmp_path):
    """Over a mesh spanning two ranks, rank 0 writes the one file and both
    read it back after the barrier; ``CNNHead.load`` in this process reads
    it as it reads a one-device save."""
    path = tmp_path / "head.pt"
    results = _run_children([[sys.executable, "-c", _SAVE_CHILD, str(tmp_path / "store"), str(r), str(path)]
                             for r in (0, 1)])
    for r, (rc, text) in enumerate(results):
        assert rc == 0, f"rank {r}:\n{text}"
    records = [json.loads(text.strip().splitlines()[-1]) for _, text in results]
    assert [(d["rank"], d["writes"], d["same"]) for d in records] == [(0, 1, True), (1, 0, True)]
    from tpumcia_torch.models.train import CNNHead

    head = CNNHead.load(path, device="cpu")
    assert head.config.width == 8 and head.mesh is None and head.model.in_channels == 2
