"""tpumcia's five examples on the port, one module each (counterparts of
``examples/*.py``), run as ``python -m tpumcia_torch.examples.<name>``:

* ``cnn_workflow``: the ResNet with channel occlusion / permutation
  importance and a spatial occlusion map (BASELINE config 3);
* ``notebook_workflow``: the reference notebook end to end (features, the
  random forest, MDI and permutation importance; ``--out DIR`` writes the
  figures, which needs matplotlib);
* ``streaming_scale``: resumable sharded extraction (config 5 in miniature);
* ``cytometry_h5``: 12-channel 16-bit h5 objects with masks and donor
  splits (config 4); it writes h5 files, so it needs ``h5py``;
* ``multihost_pipeline``: two local ranks (gloo) over one mesh: sharded
  statistics, the collective scaler, the sharded sweep, ``fit_cnn(mesh=)``
  and ``stream_extract(mesh=)``.

Each takes ``--device`` (default ``cuda``; an error where there is no card,
``--device cpu`` runs the kernel's plain version) and ``--tiny`` (the size
the CPU tests use). None imports ``jax``, ``tpumcia`` or ``sklearn``.
"""

from __future__ import annotations

import argparse


def parser(doc: str) -> argparse.ArgumentParser:
    """An example's argument parser with ``--device`` and ``--tiny``."""
    p = argparse.ArgumentParser(description=doc, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda",
                   help="the device to run on (default: cuda; 'cpu' runs the kernel's plain version)")
    p.add_argument("--tiny", action="store_true", help="a tiny size (the CPU tests' size)")
    return p


def device_of(p: argparse.ArgumentParser, args):
    """``args.device`` as a ``torch.device``; an argparse error where it
    names a CUDA device and there is none."""
    import torch

    from tpumcia_torch.utils.device import NoCUDADevice, require_device

    try:
        return require_device(torch.device(args.device), f"--device {args.device}")
    except NoCUDADevice as e:
        p.error(str(e))
    except RuntimeError as e:
        p.error(f"invalid --device {args.device!r}: {e}")
