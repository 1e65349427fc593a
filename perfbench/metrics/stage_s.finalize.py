"""Seconds a call spends in the stage `finalize`, as `utils.profiling.StageTimer`
splits one call of the traced run (it synchronises the device at each
stage's end, so read the split, not the sum)."""


def read(ctx):
    return (ctx.get("stages") or {}).get("finalize")
