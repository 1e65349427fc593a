"""The benchmark of tpumcia_torch: one run of one cell on one NVIDIA card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``, ``perfbench/``
and the ``tpumcia_torch`` package. The cell's inputs are made on the card
from ``--seed``; after a warm-up, ``--trace 0`` calls the program's entry
that the cell's configuration names (``entries/<entry>.py``; ``run_pipeline``
by default) back to back for ``--seconds`` seconds and reports the cell's
end-to-end metrics, ``--trace 1`` calls it under ``torch.profiler`` for
``harness.TRACED_CALLS`` calls and reports its per-layer metrics. Either way the
judged call's outputs are then compared with the entry's plain reference
(``reference.py`` by default), and the last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
(``breakdown`` with ``--trace 1``) and ``checks``, each number compared
beside its limit. Without a card, or with fewer than the cell asks for, it
exits 3 and prints no result. ``--device cpu --objects N`` rehearses a run
on the CPU at a small size (the kernels' plain versions; no device
metric). The host's thread pools are set to ``THREADS`` before anything
loads them.
"""

import os
import sys
import time

T_START = time.perf_counter()
THREADS = 1  # PyTorch's intra-op pool, OpenMP and the BLAS pools
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = str(THREADS)

import argparse  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: a rehearsal with the kernels' plain versions")
    ap.add_argument("--objects", type=int, default=0, help="a rehearsal's collection size")
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(THREADS)
    print(f"host threads: {THREADS}", file=sys.stderr)
    try:
        from perfbench import harness
        import tpumcia_torch  # noqa: F401
    except ImportError as e:
        print(f"cannot load the program: {e}", file=sys.stderr)
        return 2
    chips = harness.load_cell(args.workload)["cell"]["chips"]
    if args.device == "cuda" and not (torch.cuda.is_available() and torch.cuda.device_count() >= chips):
        print(f"the cell needs {chips} CUDA device(s); this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    return harness.run(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
