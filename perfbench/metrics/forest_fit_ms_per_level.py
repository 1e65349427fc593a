"""Milliseconds of the forest's fit a level grown: the split call's stage
`head` (the fit, on a forest call) over the levels that call grew
(`COUNTERS["forest_levels"]`, each chunk of trees counting its own, as the
entry kept it); none where the program has no such counter."""


def read(ctx):
    fit = (ctx.get("stages") or {}).get("head")
    levels = (ctx.get("shape") or {}).get("counters", {}).get("forest_levels")
    if fit is None or not levels:
        return None
    return 1000.0 * fit / levels
