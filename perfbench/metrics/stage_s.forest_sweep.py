"""Seconds a forest call spends in its importance: the stage `importance`,
as `utils.profiling.StageTimer` splits one call of the traced run (on a
forest call the per-feature permutation sweep through the forest, then MDI,
which is nearly free)."""


def read(ctx):
    return (ctx.get("stages") or {}).get("importance")
