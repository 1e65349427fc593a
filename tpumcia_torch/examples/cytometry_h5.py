"""Imaging-flow-cytometry workflow (BASELINE config 4; the port's
``examples/cytometry_h5.py``): 12-channel 16-bit h5 objects with masks,
donor-grouped splits, masked intensity / texture / morphology features and
channel importance.

    python -m tpumcia_torch.examples.cytometry_h5 [--work-dir DIR]
    python -m tpumcia_torch.examples.cytometry_h5 --tiny --device cpu

It writes the objects as h5 files and reads them back, so it needs
``h5py``; the card's machine has none, so it runs in the CPU tests only.
Without ``--work-dir`` the files go to a temporary directory that is
removed at the end.
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

import numpy as np

from tpumcia_torch.examples import device_of, parser


def make_dataset(root: Path, n=80, hw=48, channels=12, signal_ch=4, seed=7):
    from tpumcia_torch.io.h5 import write_object

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:hw, :hw]
    names = [f"marker{c + 1}" for c in range(channels)]
    for i in range(n):
        label = ["activated", "resting"][i % 2]
        img = rng.integers(200, 1500, size=(hw, hw, channels)).astype(np.uint16)
        cy, cx = rng.uniform(hw * 0.35, hw * 0.65, 2)
        r = np.hypot(yy - cy, xx - cx)
        cell = r < rng.uniform(10, 16)
        boost = (np.exp(-r / 8) * 38000) if label == "activated" else (cell * 6000)
        img[:, :, signal_ch] = np.clip(img[:, :, signal_ch] + boost.astype(np.uint16), 0, 65535)
        write_object(
            root / f"{i:05d}.h5", img,
            mask=np.repeat(cell[:, :, None], channels, 2).astype(np.uint8),
            label=label, donor=f"donor{i % 8}", experiment="run1", channels=names,
        )


def run(work_dir: Path, device, n: int) -> None:
    import tpumcia_torch as tt
    from tpumcia_torch.config import (
        FeatureConfig, HeadConfig, ImportanceConfig, PipelineConfig, SplitConfig,
    )

    root = work_dir / "objects"
    root.mkdir(parents=True, exist_ok=True)
    make_dataset(root, n=n)

    objs = tt.load_objects(root)
    print(f"{len(objs)} objects {objs.images.shape} {objs.images.dtype}, "
          f"channels={objs.channels[:3]}..., donors={sorted({str(d) for d in objs.donors})}")

    cfg = PipelineConfig(
        features=FeatureConfig(include_morphology=True),
        head=HeadConfig(kind="logistic", num_steps=400),
        importance=ImportanceConfig(n_repeats=5),
        split=SplitConfig(test_size=0.3, group_by="donor"),
    )
    res = tt.analyze_objects(objs, device=device, config=cfg)

    train_donors = {str(d) for d in objs.donors[res.train_idx]}
    test_donors = {str(d) for d in objs.donors[res.test_idx]}
    print(f"donor split: train={sorted(train_donors)} test={sorted(test_donors)}")
    if train_donors & test_donors:
        raise SystemExit(f"donors in both splits: {sorted(train_donors & test_donors)}")
    print(res.report)
    print(res.channel_result.summary())


def main(argv=None) -> int:
    p = parser(__doc__)
    p.add_argument("--work-dir", default=None, help="keep the h5 objects in this directory")
    args = p.parse_args(argv)
    device = device_of(p, args)
    n = 32 if args.tiny else 80
    if args.work_dir:
        run(Path(args.work_dir), device, n)
    else:
        with tempfile.TemporaryDirectory(prefix="tpumcia_cytometry_") as tmp:
            run(Path(tmp), device, n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
