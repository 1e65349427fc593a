"""The readings the limits of a cell's numbers are set from: on each of many
seeds, the program's one call at the cell's own size against the plain
reference, and on the first few seeds each of the entry's controls (its
reference one precision step down; for ``pipeline``, ``reference.py``'s
``bf16`` and ``tf32_head``) against the reference. The call, the reference
and the numbers are the cell's entry's (``entries/<entry>.py``), as in a run.

    python3 perfbench/readings.py --workload <cell> --seeds 12 --controls 3 [--first 2200000000]

One process for all seeds (the set-up once); one JSON line a seed and
side on standard output. Not part of a benchmark run.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from perfbench import run as _run  # noqa: E402  (sets the host's thread pools first)

import argparse  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from perfbench import harness  # noqa: E402


def seed_readings(spec, seed, device, *, control: bool) -> list[dict]:
    """[program vs reference] (and each control vs reference) on one seed."""
    entry = harness.load_entry(spec)
    inputs = harness.make_inputs(spec, seed, device)
    result = entry.call(inputs, spec["pipeline"], device)
    prog = entry.program_outputs(result)
    del result
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = entry.reference_outputs(spec, inputs, device)
    limits = spec["traffic"].get("limits", {})
    out = [{"seed": seed, "side": "program", **entry.readings(prog, ref, limits)}]
    if control:
        for mode in entry.CONTROLS:
            ctrl = entry.reference_outputs(spec, inputs, device, control=mode)
            out.append({"seed": seed, "side": f"control_{mode}", **entry.readings(ctrl, ref, limits)})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--first", type=int, default=2_200_000_000)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--objects", type=int, default=0)
    args = ap.parse_args(argv)
    torch.set_num_threads(_run.THREADS)
    spec = harness.load_cell(args.workload)
    if args.objects:
        spec["data"]["objects"] = args.objects
    device = torch.device(args.device)
    for i in range(args.seeds):
        for line in seed_readings(spec, args.first + 7919 * i, device, control=i < args.controls):
            print(json.dumps({"workload": args.workload, **line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
