"""Time this checkout's GLCM statistics kernel against another checkout's on
one NVIDIA GPU, in turns, on the cases chip_smoke.py's kernel phase times
(its ``timed_cases``: the same shapes and data).

    python3 kernel_ab.py OTHER [--reps 20]

OTHER is another checkout (its ``tpumcia_torch/csrc/glcm_stats.cu``) or a
``.cu`` file: an earlier source, whose C entry ``tpumcia_glcm_stats`` takes
no ``table_bits`` argument (the layout before the pair table), or a variant
of this one (told apart by its ``tpumcia_glcm_launch_info`` entry). The
cases past 4096 levels (form B1e) go through ``tpumcia_glcm_stats_workspace``,
each side with the workspace its own ``tpumcia_glcm_workspace_info`` asks
for (an earlier source's takes no offset count: read from its source text),
both printed; a source without that entry is not timed there. Both
sources are built with nvcc (the other one into ``build/kernel_ab/``), fed
the same inputs and output buffers, and timed with CUDA events in the order
other, this, this, other: the median of ``--reps`` launches after 3 warm-up
launches, each time. Before timing, each
shape's outputs of the two kernels are held equal (integer fields bit-equal,
dstats[3] to rel 1e-6). Prints one line per shape and, last, one JSON
object with the card's name and power limit and every time, which is also
appended to ``build/kernel_ab/kernel_ab.jsonl``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def _build_other(other: Path) -> tuple[ctypes.CDLL, bool, bool]:
    """The other source's library, bound through ``_build``'s signatures;
    whether its ``tpumcia_glcm_stats`` takes table_bits, and whether its
    ``tpumcia_glcm_workspace_info`` takes an offset count."""
    from tpumcia_torch import _build

    src = other if other.suffix == ".cu" else other / "tpumcia_torch" / "csrc" / "glcm_stats.cu"
    out = ROOT / "build" / "kernel_ab"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / f"libother_{os.getpid()}.so"
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr[-4000:]}")
    dll = _build.load_library(lib)
    takes_bits = hasattr(dll, "tpumcia_glcm_launch_info")
    if not takes_bits:
        # the one difference of a source from before the pair table: its
        # tpumcia_glcm_stats has no table_bits argument (the 14th)
        argtypes = _build._SIGNATURES["tpumcia_glcm_stats"][1]
        dll.tpumcia_glcm_stats.argtypes = argtypes[:13] + argtypes[14:]
    decl = re.search(r"tpumcia_glcm_workspace_info\(([^)]*)\)", src.read_text())
    takes_offsets = decl is not None and "num_offsets" in decl.group(1)
    if decl is not None and not takes_offsets:
        # before the level bands: (H, W, L, masked, table_bits, items, info)
        argtypes = _build._SIGNATURES["tpumcia_glcm_workspace_info"][1]
        dll.tpumcia_glcm_workspace_info.argtypes = argtypes[:5] + argtypes[6:]
    return dll, takes_bits, takes_offsets


def _workspace_bytes(lib, takes_offsets: bool, H, W, L, masked, bits, num_offsets, items) -> int:
    """The workspace bytes ``lib``'s B1e planner asks for at this shape."""
    from tpumcia_torch import _build

    info = (ctypes.c_longlong * 10)()
    args = [H, W, L, int(masked), bits, *([num_offsets] if takes_offsets else []), items, info]
    _build.check(lib.tpumcia_glcm_workspace_info(*args), "workspace info")
    return info[6]


def _nbytes(t) -> int:
    return 0 if t is None else t.numel()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, help="another checkout, or a glcm_stats.cu variant")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from chip_smoke import _cuda_events_ms, _stats_error, timed_cases, timed_label
    from tpumcia_torch import _build
    from tpumcia_torch.features import cuda_glcm
    from tpumcia_torch.features.stats import (
        SuffStats,
        cheap_limbs,
        prepare_mask,
        rescale_lut_device,
    )

    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "?"
    print(card, flush=True)
    this = _build.load_library()
    other, other_bits, other_offsets = _build_other(args.other.resolve())
    results = []
    for c in timed_cases(device):
        x, L, offsets, need_diff = c["x"], c["levels"], c["offsets"], c["need_diff"]
        B, C, H, W = x.shape
        m = None if c["mask"] is None else prepare_mask(c["mask"], (B, H, W, C), device)
        name = f'{c["form"]} ' + timed_label(x.shape, offsets, c["mask"], L, c["note"])
        O = len(offsets)
        f32 = torch.float32

        def outputs():
            return [torch.empty(s, dtype=d, device=device) for s, d in (
                ((B, C, L), f32), ((B, C), f32), ((B, C), torch.int32), ((O, B, C, L), f32),
                ((O, B, C, L), f32), ((O, B, C, 2 * L - 1 if need_diff else 4), f32),
                ((O, B, C, 4), torch.int32), ((O, B, C), f32))]

        flat = (ctypes.c_int * (2 * O))(*[v for off in offsets for v in off])
        bits = cuda_glcm.table_bits(cuda_glcm.pair_table_slots(H, W, offsets, L))
        stream = torch.cuda.current_stream(device).cuda_stream
        mask_args = [None if m is None else m.data_ptr(), 1 if m is None else m.shape[1]]
        out_this, out_other = outputs(), outputs()
        if c["form"] == "B1e":
            # each kernel with the workspace its own planner asks for
            other_runs = hasattr(other, "tpumcia_glcm_stats_workspace")
            ws = {}
            for side, lib, takes in (("this", this, True), ("other", other, other_offsets)):
                if side == "this" or other_runs:
                    n = _workspace_bytes(lib, takes, H, W, L, m is not None, bits, O, B * C)
                    ws[side] = torch.empty(n, dtype=torch.uint8, device=device) if n else None
            print(f"  {name}: workspace bytes this {_nbytes(ws['this'])}, "
                  f"other {_nbytes(ws['other']) if other_runs else None}", flush=True)
            head = [x.data_ptr(), *mask_args, B, C, H, W, L, flat, O, bits]

            def ws_args(side):
                t = ws[side]
                return [None, 0] if t is None else [t.data_ptr(), t.numel()]

            def run_this():
                _build.check(this.tpumcia_glcm_stats_workspace(
                    *head, *ws_args("this"), *[t.data_ptr() for t in out_this], stream), "this kernel")

            def run_other():
                _build.check(other.tpumcia_glcm_stats_workspace(
                    *head, *ws_args("other"), *[t.data_ptr() for t in out_other], stream),
                    "the other kernel")
        else:
            lut = rescale_lut_device(L, device)
            head = [x.data_ptr(), *mask_args, lut.data_ptr(), B, C, H, W, L, flat, O, int(need_diff),
                    int(cheap_limbs(H * W, L))]
            other_runs = True

            def run_this():
                _build.check(this.tpumcia_glcm_stats(*head, bits, *[t.data_ptr() for t in out_this], stream),
                             "this kernel")

            def run_other():
                _build.check(other.tpumcia_glcm_stats(*head, *([bits] if other_bits else []),
                                                      *[t.data_ptr() for t in out_other], stream),
                             "the other kernel")

        run_this()
        if not other_runs:
            t1 = _cuda_events_ms(run_this, args.reps, 3)
            t2 = _cuda_events_ms(run_this, args.reps, 3)
            print(f"  {name}: other has no workspace entry, this {t1!r} / {t2!r} ms", flush=True)
            results.append({"shape": name, "other_ms": None, "this_ms": [t1, t2]})
            continue
        run_other()
        torch.cuda.synchronize()
        for o in range(O):
            def stats(t):
                hist, count, vmax, ml, mr, dout, sq, pairs = t
                return SuffStats(hist, count, vmax, ml[o], mr[o], dout[o] if need_diff else None,
                                 sq[o], pairs[o], None if need_diff else dout[o])
            _stats_error(stats(out_this), stats(out_other))
        o1 = _cuda_events_ms(run_other, args.reps, 3)
        t1 = _cuda_events_ms(run_this, args.reps, 3)
        t2 = _cuda_events_ms(run_this, args.reps, 3)
        o2 = _cuda_events_ms(run_other, args.reps, 3)
        print(f"  {name}: other {o1!r} / {o2!r} ms, this {t1!r} / {t2!r} ms (outputs equal)", flush=True)
        rec = {"shape": name, "other_ms": [o1, o2], "this_ms": [t1, t2]}
        if c["form"] == "B1e":
            rec["workspace_bytes"] = {"this": _nbytes(ws["this"]), "other": _nbytes(ws["other"])}
        results.append(rec)
        del out_this, out_other, x, m, c
        torch.cuda.empty_cache()
    line = json.dumps({"card": card, "other": str(args.other), "reps": args.reps,
                       "order": "other, this, this, other",
                       "results": results})
    with open(ROOT / "build" / "kernel_ab" / "kernel_ab.jsonl", "a") as f:
        f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
