"""Seconds a forest call spends fitting its forest: the stage `head`, as
`utils.profiling.StageTimer` splits one call of the traced run (on a forest
call the fit and one scoring of the test rows; the fit is nearly all of it)."""


def read(ctx):
    return (ctx.get("stages") or {}).get("head")
