"""The port's examples (``python -m tpumcia_torch.examples.<name>``) at
``--tiny --device cpu``, each in a subprocess under a timeout: every one
exits 0 and prints its result lines; ``notebook_workflow --out`` writes the
figures; ``multihost_pipeline`` launches its two gloo workers itself; none
pulls in ``jax``, ``tpumcia`` or ``sklearn``; ``--device cuda`` without a
card is an argparse error. No tolerances: the lines are checked for what
they report (the signal channel first, a resume that recomputes nothing,
both ranks' equal CNN losses).
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 120
TOPOLOGY_VARS = ("TPUMCIA_COORDINATOR", "TPUMCIA_NUM_PROCESSES", "TPUMCIA_PROCESS_ID",
                 "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def _run(*args, timeout=TIMEOUT_S):
    env = {k: v for k, v in os.environ.items() if k not in TOPOLOGY_VARS}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, *args], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=timeout)
    return proc.returncode, proc.stdout + proc.stderr


def _example(name, *extra):
    rc, out = _run("-m", f"tpumcia_torch.examples.{name}", "--tiny", "--device", "cpu", *extra)
    assert rc == 0, out
    return out


def test_cnn_workflow():
    out = _example("cnn_workflow")
    assert "test accuracy" in out and "precision" in out
    assert re.search(r"occlusion maps: \(4, 2, 2\) peak drop: [-0-9.e]+", out)


def test_notebook_workflow_with_figures(tmp_path):
    out = _example("notebook_workflow", "--out", str(tmp_path))
    assert "feature matrix: (120, 69)" in out and "precision" in out
    assert "channel importance (mdi)" in out and "channel importance (permutation_features)" in out
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "channel_mdi.png", "permutation.png", "samples.png", "top_features_mdi.png"]
    # the signal channel first in the MDI view
    mdi = out.split("channel importance (mdi):")[1].strip().splitlines()[0]
    assert mdi.startswith("Ch1:"), out


def test_notebook_workflow_draws_nothing_without_out(tmp_path):
    rc, out = _run("-m", "tpumcia_torch.examples.notebook_workflow", "--tiny", "--device", "cpu")
    assert rc == 0, out
    assert "figures in" not in out


def test_streaming_scale_resumes(tmp_path):
    out = _example("streaming_scale", "--work-dir", str(tmp_path))
    assert re.search(r"pass 1: computed=4 skipped=0 rate=\d+ img/s features=\(120, 69\)", out), out
    assert "pass 2 (resume): computed=0 skipped=4" in out
    assert (tmp_path / "features" / "manifest.json").exists()


def test_cytometry_h5(tmp_path):
    out = _example("cytometry_h5", "--work-dir", str(tmp_path))
    assert "32 objects (32, 48, 48, 12) uint16" in out and len(list((tmp_path / "objects").glob("*.h5"))) == 32
    assert "donor split: train=" in out
    ranking = out.split("channel importance (permutation):")[1].strip().splitlines()
    assert ranking[0].startswith("marker5:"), out


def test_multihost_pipeline_launches_two_workers():
    out = _example("multihost_pipeline")
    assert "multihost demo finished: both workers OK" in out
    for pid in (0, 1):
        assert f"[proc {pid}] OK" in out and f"[proc {pid}] features: (8, 69)" in out
        assert f"[proc {pid}] sweep importances shape: (69, 3)" in out
    losses = re.findall(r"\[proc \d\] cnn loss history: (.*)", out)
    assert len(losses) == 2 and losses[0] == losses[1], out  # the all-reduce gives both ranks one model
    assert "streamed (8, 69)" in out


def test_no_card_is_an_argparse_error():
    rc, out = _run("-m", "tpumcia_torch.examples.streaming_scale", "--tiny")
    assert rc == 2 and "no CUDA device is present" in out


def test_examples_import_no_jax_tpumcia_or_sklearn():
    code = (
        "import importlib, json, sys\n"
        "for m in ('cnn_workflow', 'notebook_workflow', 'streaming_scale', 'cytometry_h5', 'multihost_pipeline'):\n"
        "    importlib.import_module('tpumcia_torch.examples.' + m)\n"
        "import tpumcia_torch.parallel.data_parallel, tpumcia_torch.models.train, tpumcia_torch.importance.occlusion\n"
        "print(json.dumps(sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'tpumcia', 'sklearn'))))\n"
    )
    rc, out = _run("-c", code)
    assert rc == 0, out
    assert json.loads(out.strip().splitlines()[-1]) == []
