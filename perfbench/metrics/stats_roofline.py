"""The GLCM statistics kernel's share of its roofline, %: the frozen byte rule
over the card's memory rate (3.35 TB/s), over the kernel's time in the
profile, summed over the traced calls' launches."""

from perfbench import counts
from perfbench.trace import GLCM_KERNEL


def read(ctx):
    kernels, sh = ctx.get("kernels"), ctx["shape"]
    if not kernels:
        return None
    seconds = sum(e - s for name, s, e in kernels if GLCM_KERNEL in name) / 1e6
    if seconds <= 0:
        return None
    per_call = counts.glcm_call_bytes(sh["objects"], sh["batch"], sh["channels"], sh["hw"],
                                      sh["levels"], mask_channels=sh["mask_channels"],
                                      need_diff=sh["need_diff"])
    return 100.0 * per_call * ctx["calls"] / counts.HBM_BYTES_PER_S / seconds
