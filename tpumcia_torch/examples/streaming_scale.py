"""Streaming sharded extraction with resume (BASELINE config 5 in
miniature; the port's ``examples/streaming_scale.py``): manifest-driven
shards, atomic outputs, a restart that skips the completed work.

    python -m tpumcia_torch.examples.streaming_scale [--work-dir DIR]
    python -m tpumcia_torch.examples.streaming_scale --tiny --device cpu

Without ``--work-dir`` the shards go to a temporary directory that is
removed at the end.
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

from tpumcia_torch.examples import device_of, parser


def run(work_dir: Path, device, n_per_class: int, shard_size: int) -> None:
    import torch

    from tpumcia_torch.io.synthetic import synthetic_mednist
    from tpumcia_torch.pipeline.streaming import stream_extract
    from tpumcia_torch.preprocess.synth import add_noise_channels

    out = work_dir / "features"
    gray, labels, _ = synthetic_mednist(n_per_class, seed=0)

    def fetch(idx):
        # host decode stand-in; the synthesis runs on the device, seeded per shard
        generator = torch.Generator(device=device).manual_seed(int(idx[0]))
        return add_noise_channels(torch.from_numpy(gray[idx]).to(device), generator), None, labels[idx]

    res = stream_extract(fetch, len(gray), out, device=device, shard_size=shard_size)
    print(f"pass 1: computed={res.shards_computed} skipped={res.shards_skipped} "
          f"rate={res.images_per_second:.0f} img/s features={res.features.shape}")

    res2 = stream_extract(fetch, len(gray), out, device=device, shard_size=shard_size)
    print(f"pass 2 (resume): computed={res2.shards_computed} skipped={res2.shards_skipped}")
    if res2.shards_computed != 0:
        raise SystemExit(f"resume recomputed {res2.shards_computed} shards")
    print(f"manifest + shards + progress.jsonl in {out}")


def main(argv=None) -> int:
    p = parser(__doc__)
    p.add_argument("--work-dir", default=None, help="keep the shards in this directory")
    args = p.parse_args(argv)
    device = device_of(p, args)
    n_per_class, shard_size = (20, 32) if args.tiny else (300, 256)
    if args.work_dir:
        run(Path(args.work_dir), device, n_per_class, shard_size)
    else:
        with tempfile.TemporaryDirectory(prefix="tpumcia_stream_") as tmp:
            run(Path(tmp), device, n_per_class, shard_size)
    return 0


if __name__ == "__main__":
    sys.exit(main())
