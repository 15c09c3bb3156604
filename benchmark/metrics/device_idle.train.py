"""device layer: the share of the traced window in which no operation ran
on the card (the profiler's CUPTI trace: the union of device activity)."""


def read(ctx):
    t = ctx.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * max(t["window_s"] - t["busy_s"], 0.0) / t["window_s"]
