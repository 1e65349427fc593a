"""Learned-feature path: the ResNet-style CNN on multichannel images, with
channel occlusion / permutation importance and a spatial occlusion map
(BASELINE config 3; the port's ``examples/cnn_workflow.py``).

    python -m tpumcia_torch.examples.cnn_workflow             # on the card
    python -m tpumcia_torch.examples.cnn_workflow --tiny --device cpu
"""

from __future__ import annotations

import sys

import numpy as np

from tpumcia_torch.examples import device_of, parser


def main(argv=None) -> int:
    from tpumcia_torch.importance.occlusion import occlusion_map
    from tpumcia_torch.io.synthetic import synthetic_multichannel
    from tpumcia_torch.models.train import CNNConfig
    from tpumcia_torch.pipeline.run_cnn import run_cnn_pipeline

    p = parser(__doc__)
    args = p.parse_args(argv)
    device = device_of(p, args)
    n_per_class, hw, width, epochs = (12, 16, 8, 3) if args.tiny else (60, 32, 16, 8)

    images, labels, _ = synthetic_multichannel(n_per_class, num_classes=4, hw=hw, seed=1, device=device)
    cfg = CNNConfig(num_classes=4, width=width, depth="10", epochs=epochs, batch_size=32, learning_rate=2e-3)
    res = run_cnn_pipeline(images, labels, device=device, config=cfg, n_repeats=3)
    print(res.report)
    print(res.summary())

    # spatial saliency for a few test images
    x = images[res.test_idx[:4]].astype(np.float32) / 255.0
    maps = occlusion_map(res.head, x, labels[res.test_idx[:4]], window=8, stride=8)
    print("occlusion maps:", maps.shape, "peak drop:", float(maps.max()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
