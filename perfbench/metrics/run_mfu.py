"""The whole call's share of the card's peak, %: the logistic head's and
both sweeps' matrix-product FLOPs (the frozen counts) over the traced mean
call time times the peak of the head's precision (float32, or TF32 where
it is on). The forest does comparisons and gathers, not FLOPs: no reading."""

from perfbench import counts


def read(ctx):
    sh, tl = ctx["shape"], ctx.get("timeline")
    if sh["head_kind"] != "logistic" or not tl or tl["busy_s"] <= 0:
        return None
    flops = (counts.head_flops(sh["n_train"], sh["features"], sh["classes"], sh["steps"])
             + counts.sweep_flops(sh["n_test"], sh["features"], sh["classes"], sh["channels"],
                                  sh["repeats"]))
    call_s = tl["window_s"] / ctx["calls"]
    return 100.0 * flops / (call_s * counts.flops_peak(ctx["tf32"]))
