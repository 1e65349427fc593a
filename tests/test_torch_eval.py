"""The port's ``eval`` CLI, profiling helpers and plots on the CPU, against
``tpumcia.eval`` on the same arguments: the same metrics events with the
same keys, channel 0 ranked first in both (the two packages draw their noise
channels from different streams, so values are not compared), the same
argparse errors, ``--distributed`` refused naming ROADMAP A14, the three
figures of ``--plots``, a trace file from ``capture_trace``, and
``ThroughputMeter`` held to the contract of ``tests/test_profiling_utils.py``.
"""

import json

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (limits torch to one thread)
from tpumcia import eval as jax_eval
from tpumcia_torch import eval as torch_eval
from tpumcia_torch.utils import profiling


def _events(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_cli_synthetic_matches_tpumcia(tmp_path, capsys):
    ours, theirs = tmp_path / "torch.jsonl", tmp_path / "jax.jsonl"
    args = ["--source", "synthetic", "--n-per-class", "30"]
    assert torch_eval.main([*args, "--device", "cpu", "--metrics", str(ours)]) == 0
    out = capsys.readouterr().out
    assert "precision" in out and "channel importance (permutation):" in out
    assert jax_eval.main([*args, "--metrics", str(theirs)]) == 0
    a, b = _events(ours), _events(theirs)
    assert [e["event"] for e in a] == [e["event"] for e in b] == ["data_loaded", "pipeline_done"]
    for x, y in zip(a, b):
        assert set(x) == set(y)
    assert a[0]["n"] == b[0]["n"] == 180 and a[0]["shape"] == b[0]["shape"] == [180, 64, 64, 3]
    for e in (a[1], b[1]):
        assert e["channel_ranking"][0] == 0 and sorted(e["channel_ranking"]) == [0, 1, 2]
        assert e["test_accuracy"] >= 0.9
        assert {"features_s", "fit_s", "importance_s"} <= set(e["timings"])


def test_cli_reads_the_sample_config_and_synthesizes_noise(tmp_path):
    """``configs/sample_config.json`` as it is (exact precision, a mesh entry
    of one device), and a config with ``synth.noise_channels``: the grayscale
    batch goes to ``run_pipeline``, which synthesizes the channels."""
    metrics = tmp_path / "m.jsonl"
    base = ["--source", "synthetic", "--n-per-class", "8", "--device", "cpu", "--metrics", str(metrics)]
    assert torch_eval.main([*base, "--config", "configs/sample_config.json"]) == 0
    synth = tmp_path / "synth.json"
    synth.write_text(json.dumps({"synth": {"noise_channels": 2, "seed": 3}, "head": {"num_steps": 50}}))
    assert torch_eval.main([*base, "--config", str(synth)]) == 0
    events = _events(metrics)
    assert [e["shape"] for e in events if e["event"] == "data_loaded"] == [[48, 64, 64, 3], [48, 64, 64]]
    assert len(events[-1]["channel_ranking"]) == 3


@pytest.mark.parametrize("argv,message", [
    (["--source", "h5"], "--data is required for source=h5"),
    (["--source", "folder"], "--data is required for source=folder"),
    (["--source", "nope"], "invalid choice"),
    (["--config", "/nonexistent/config.json"], "config file not found"),
    (["--config", "MALFORMED"], "invalid config"),
    (["--config", "UNKNOWN_KEY"], "invalid config"),
])
def test_cli_argument_errors_match_tpumcia(argv, message, tmp_path, capsys):
    bad = {"MALFORMED": "{not json", "UNKNOWN_KEY": json.dumps({"features": {"no_such_key": 1}})}
    argv = list(argv)
    if argv[-1] in bad:
        path = tmp_path / "bad.json"
        path.write_text(bad[argv[-1]])
        argv[-1] = str(path)
    errors = []
    for main, extra in ((torch_eval.main, ["--device", "cpu"]), (jax_eval.main, [])):
        with pytest.raises(SystemExit) as exc:
            main([*argv, *extra])
        assert exc.value.code == 2
        err = capsys.readouterr().err
        assert message in err, err
        errors.append(err.splitlines()[-1].split("error: ", 1)[1])
    if "invalid choice" not in message:  # argparse names the program there
        assert errors[0] == errors[1]


def test_cli_refuses_distributed_and_a_missing_gpu(capsys, monkeypatch):
    """``--distributed`` with no coordinator runs as one process and says so
    (tpumcia's line); without a card the default device fails."""
    for k in ("TPUMCIA_COORDINATOR", "TPUMCIA_NUM_PROCESSES", "TPUMCIA_PROCESS_ID",
              "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert torch_eval.main(["--distributed", "--device", "cpu", "--source", "synthetic",
                            "--n-per-class", "8"]) == 0
    out = capsys.readouterr().out
    assert "distributed: {'process_index': 0, 'process_count': 1" in out
    assert "(single process: no coordinator configured)" in out and "channel importance" in out
    if not torch.cuda.is_available():
        # the default device is the card: without one the CLI fails, it does not move to the CPU
        with pytest.raises(SystemExit) as exc:
            torch_eval.main(["--source", "synthetic", "--n-per-class", "4"])
        assert exc.value.code == 2 and "no CUDA device" in capsys.readouterr().err
    with pytest.raises(SystemExit) as exc:
        torch_eval.main(["--device", "not-a-device"])
    assert exc.value.code == 2 and "invalid --device" in capsys.readouterr().err


def test_cli_plots_and_profile(tmp_path, capsys):
    plots, trace_dir = tmp_path / "plots", tmp_path / "trace"
    assert torch_eval.main(["--source", "synthetic", "--n-per-class", "10", "--device", "cpu",
                            "--plots", str(plots), "--profile", str(trace_dir)]) == 0
    out = capsys.readouterr().out
    assert f"figures written to {plots}" in out and f"profiler trace in {trace_dir}" in out
    for name in ("top_features.png", "channel_importance.png", "channel_permutation.png"):
        assert (plots / name).stat().st_size > 1000, name
    trace = json.loads((trace_dir / "trace.json").read_text())
    assert len(trace["traceEvents"]) > 100


def test_capture_trace_and_trace_regions(tmp_path):
    with profiling.capture_trace(str(tmp_path / "t")) as prof:
        with profiling.trace("tpumcia_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    names = {e.get("name") for e in json.loads((tmp_path / "t" / "trace.json").read_text())["traceEvents"]}
    assert "tpumcia_region" in names
    assert any(k.key == "tpumcia_region" for k in prof.key_averages())
    with profiling.trace("outside a profiler"):  # a no-op without one
        pass


def test_throughput_meter_accumulates():
    m = profiling.ThroughputMeter()
    with m.measure("extract", 100):
        pass
    with m.measure("extract", 50):
        pass
    with m.measure("fit", 10):
        pass
    rep = m.report()
    assert rep["extract"]["items"] == 150
    assert rep["fit"]["items"] == 10
    assert rep["extract"]["per_second"] == m.rate("extract") > 0
    assert m.rate("missing") == 0.0
    from tpumcia.utils.profiling import ThroughputMeter as JaxMeter

    theirs = JaxMeter()
    with theirs.measure("fit", 10):
        pass
    assert set(rep["fit"]) == set(theirs.report()["fit"]) == {"items", "seconds", "per_second"}


def test_plots_match_tpumcias_module():
    """The port's plots module is tpumcia's, function for function, and
    draws the occlusion overlay from the port's ``occlusion_map`` shape."""
    import inspect

    from tpumcia.reports import plots as jplots
    from tpumcia_torch.reports import plots as tplots

    public = [n for n, f in inspect.getmembers(jplots, inspect.isfunction) if not n.startswith("_")]
    assert public and all(
        inspect.signature(getattr(tplots, n)) == inspect.signature(getattr(jplots, n)) for n in public)
    rng = np.random.default_rng(0)
    fig = tplots.plot_occlusion_maps(rng.random((4, 16, 16, 3)), rng.random((4, 2, 2)), n=3)
    assert len(fig.axes) == 3
    fig2 = tplots.plot_sample_grid(rng.integers(0, 255, (9, 16, 16)), labels=np.arange(9) % 3)
    assert len(fig2.axes) == 9
