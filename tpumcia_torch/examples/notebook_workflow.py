"""The reference notebook's workflow, end to end (the port's
``examples/notebook_workflow.py``): on the synthetic MedNIST stand-in,
sample grid -> noise-channel synthesis -> 69 features -> split -> random
forest -> classification report -> MDI feature and channel importance ->
permutation importance.

    python -m tpumcia_torch.examples.notebook_workflow [--out DIR]
    python -m tpumcia_torch.examples.notebook_workflow --tiny --device cpu

With ``--out DIR`` it writes the notebook's figures there
(``reports.plots``, which imports matplotlib: without it that raises);
without ``--out`` it draws none.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

from tpumcia_torch.examples import device_of, parser


def main(argv=None) -> int:
    import torch

    from tpumcia_torch.config import FeatureConfig, HeadConfig, ImportanceConfig
    from tpumcia_torch.features.extract import FeatureMatrix, extract_features
    from tpumcia_torch.importance.channels import channel_importance
    from tpumcia_torch.io.synthetic import synthetic_mednist
    from tpumcia_torch.models.heads import fit_head
    from tpumcia_torch.preprocess.synth import add_noise_channels
    from tpumcia_torch.utils.metrics import classification_report
    from tpumcia_torch.utils.split import train_test_split_indices

    p = parser(__doc__)
    p.add_argument("--out", default=None, help="write the figures into this directory")
    args = p.parse_args(argv)
    device = device_of(p, args)
    n_per_class, trees, repeats = (20, 10, 3) if args.tiny else (200, 100, 10)
    out = None
    if args.out:
        from tpumcia_torch.reports import plots

        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)

    # cells 5-7: dataset + sample grid
    gray, labels, class_names = synthetic_mednist(n_per_class, seed=0)
    if out:
        plots.plot_sample_grid(gray, labels, class_names).savefig(out / "samples.png")

    # cell 9: synthesized noise channels (seeded here, unlike the reference)
    generator = torch.Generator(device=device).manual_seed(0)
    images = add_noise_channels(torch.from_numpy(gray).to(device), generator)

    # cells 13-17: 23 features x 3 channels, batched on the device
    fm = extract_features(images, device=device, config=FeatureConfig())
    print(f"feature matrix: {fm.shape}")

    # cells 19-21: split / scale / random forest / report
    X = np.nan_to_num(np.asarray(fm.values, np.float32))
    split = train_test_split_indices(len(X), test_size=0.25, seed=0, stratify=labels)
    head = fit_head(X[split.train_idx], labels[split.train_idx], device=device,
                    config=HeadConfig(kind="random_forest", n_estimators=trees))
    pred = head.predict(X[split.test_idx])
    print(classification_report(labels[split.test_idx], pred, target_names=class_names))

    fm_test = FeatureMatrix(values=X[split.test_idx], names=fm.names, num_channels=3)

    # cells 23-26: MDI feature importance + channel aggregation
    mdi = channel_importance(head, fm_test, method="mdi")
    if out:
        plots.plot_top_features(mdi.feature_importances, fm.names).savefig(out / "top_features_mdi.png")
        plots.plot_channel_importance(mdi).savefig(out / "channel_mdi.png")
    print(mdi.summary())

    # cell 28: permutation importance on the test set (device sweep)
    perm = channel_importance(
        head, fm_test, labels[split.test_idx], method="permutation_features",
        config=ImportanceConfig(n_repeats=repeats, seed=42),
    )
    if out:
        plots.plot_permutation_importance(perm.extras["permutation"], fm.names).savefig(out / "permutation.png")
        print(f"figures in {out}/")
    print(perm.summary())
    return 0


if __name__ == "__main__":
    sys.exit(main())
