"""The share of the traced window in which no kernel ran on the device, %."""


def read(ctx):
    tl = ctx.get("timeline")
    if not tl or tl["window_s"] <= 0 or tl["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tl["busy_s"] / tl["window_s"])
