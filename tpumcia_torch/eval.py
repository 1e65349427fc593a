"""Config-driven evaluation entry point (counterpart of ``tpumcia.eval``):
run the full pipeline from a JSON config over an h5 object directory, a
MedNIST-style image folder, or the synthetic demo set, on one device.

    python -m tpumcia_torch.eval --config configs/sample_config.json
    python -m tpumcia_torch.eval --data /path/to/objects --source h5
    python -m tpumcia_torch.eval --source synthetic --n-per-class 200 --plots out/

It runs on a CUDA device (``--device cuda``, the default: every visible
card, which ``mesh.data=-1`` spreads the run over) and fails where there is
none; ``--device cpu`` asks for the CPU, where the GLCM kernel's plain
version runs. ``--distributed`` joins a ``torch.distributed`` process group
first (``parallel.distributed.init_distributed``: torchrun's variables, or
``TPUMCIA_COORDINATOR`` / ``TPUMCIA_NUM_PROCESSES`` / ``TPUMCIA_PROCESS_ID``
as ``launch_eval.sh`` sets them), so the mesh spans every rank's card:

    torchrun --nproc-per-node 4 -m tpumcia_torch.eval --distributed --source h5 --data objects/
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np


def _load_data(args, cfg, device):
    """tpumcia's three sources, routed as its ``_load_data`` routes them ->
    (images, labels, masks, channel names, groups)."""
    if args.source == "h5":
        import torch

        from tpumcia_torch.io.h5 import load_objects
        from tpumcia_torch.preprocess.normalize import quantize_to_levels

        objs = load_objects(args.data, limit=args.limit)
        images = np.asarray(objs.images)
        if images.dtype == np.uint16:
            # 16-bit data is quantized on the device and stays there
            images = quantize_to_levels(
                torch.from_numpy(images).to(device),
                levels=cfg.features.glcm.levels, src_levels=65536,
            )
        labels = objs.labels
        if labels is None:
            raise SystemExit("h5 objects carry no labels")
        groups = objs.donors if cfg.split.group_by == "donor" else (
            objs.experiments if cfg.split.group_by == "experiment" else None
        )
        return images, labels, objs.masks, objs.channels, groups

    if args.source == "folder":
        import torch

        from tpumcia_torch.io.mednist import index_image_folder, load_images
        from tpumcia_torch.preprocess.synth import add_noise_channels

        idx = index_image_folder(args.data)
        files = idx.files[: args.limit] if args.limit else idx.files
        labels = idx.labels[: len(files)]
        gray = load_images(files)
        named = np.asarray(idx.class_names)[labels]
        if cfg.synth.noise_channels > 0:
            # config-driven synthesis: run_pipeline gets the grayscale batch
            # and synthesizes the seeded noise channels on the device
            return np.asarray(gray), named, None, None, None
        generator = torch.Generator(device=device).manual_seed(cfg.seed)
        images = add_noise_channels(torch.from_numpy(np.asarray(gray)).to(device), generator)
        return images.cpu().numpy(), named, None, None, None

    # synthetic demo
    from tpumcia_torch.io.synthetic import synthetic_mednist, synthetic_multichannel

    if cfg.synth.noise_channels > 0:
        gray, labels, class_names = synthetic_mednist(args.n_per_class, seed=cfg.seed)
        return np.asarray(gray), np.asarray(class_names)[labels], None, None, None
    images, labels, class_names = synthetic_multichannel(
        args.n_per_class, seed=cfg.seed, device=device
    )
    return images, np.asarray(class_names)[labels], None, None, None


def main(argv=None) -> int:
    from tpumcia_torch.config import PipelineConfig
    from tpumcia_torch.pipeline.run import run_pipeline
    from tpumcia_torch.utils.logging import MetricsLogger

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", type=str, default=None, help="JSON PipelineConfig")
    p.add_argument("--data", type=str, default=None, help="data directory")
    p.add_argument(
        "--source", choices=("h5", "folder", "synthetic"), default="synthetic"
    )
    p.add_argument("--n-per-class", type=int, default=200)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--plots", type=str, default=None, help="figure output dir")
    p.add_argument("--metrics", type=str, default=None, help="JSONL metrics file")
    p.add_argument(
        "--profile", type=str, default=None,
        help="capture a torch.profiler trace of the pipeline into this dir (trace.json)",
    )
    p.add_argument(
        "--device", type=str, default="cuda",
        help="the device to run on (default: cuda; 'cpu' runs the kernel's plain version)",
    )
    p.add_argument(
        "--distributed", action="store_true",
        help=(
            "join a torch.distributed process group before building the mesh "
            "(topology from torchrun's variables or TPUMCIA_COORDINATOR / "
            "TPUMCIA_NUM_PROCESSES / TPUMCIA_PROCESS_ID — see launch_eval.sh)"
        ),
    )
    args = p.parse_args(argv)

    import torch

    from tpumcia_torch.utils.device import NoCUDADevice, require_device

    try:
        device = require_device(torch.device(args.device), f"--device {args.device}")
    except NoCUDADevice as e:
        p.error(str(e))
    except RuntimeError as e:
        p.error(f"invalid --device {args.device!r}: {e}")
    if args.distributed:
        from tpumcia_torch.parallel.distributed import init_distributed, process_summary

        multi = init_distributed(backend=None if device.type == "cuda" else "gloo")
        print(f"distributed: {process_summary()}"
              + ("" if multi else " (single process: no coordinator configured)"))

    if args.config and not Path(args.config).exists():
        p.error(f"config file not found: {args.config}")
    if args.config:
        try:
            cfg = PipelineConfig.from_json(args.config)
        except (ValueError, TypeError, KeyError) as e:
            p.error(f"invalid config {args.config}: {e}")
    else:
        cfg = PipelineConfig()
    if args.source in ("h5", "folder") and not args.data:
        p.error(f"--data is required for source={args.source}")

    log = MetricsLogger(args.metrics)
    images, labels, masks, channel_names, groups = _load_data(args, cfg, device)
    log.log("data_loaded", n=len(images), shape=list(images.shape))

    def run():
        return run_pipeline(
            images, labels, device=device, mask=masks, config=cfg,
            channel_names=channel_names, groups=groups,
        )

    if args.profile:
        from tpumcia_torch.utils.profiling import capture_trace

        with capture_trace(args.profile):
            result = run()
        print(f"profiler trace in {args.profile}")
    else:
        result = run()
    log.log(
        "pipeline_done",
        test_accuracy=result.test_accuracy,
        channel_ranking=[int(c) for c in result.channel_result.ranking],
        timings=result.timings,
    )
    print(result.report)
    print(result.channel_result.summary())

    if args.plots:
        out = Path(args.plots)
        out.mkdir(parents=True, exist_ok=True)
        from tpumcia_torch.reports import plots

        if result.feature_result is not None:
            fig = plots.plot_top_features(
                result.feature_result.feature_importances, result.features.names
            )
            fig.savefig(out / "top_features.png", dpi=120)
            fig2 = plots.plot_channel_importance(result.feature_result)
            fig2.savefig(out / "channel_importance.png", dpi=120)
        perm = result.channel_result.extras.get("permutation")
        if perm is not None:
            fig3 = plots.plot_channel_importance(result.channel_result)
            fig3.savefig(out / "channel_permutation.png", dpi=120)
        print(f"figures written to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
