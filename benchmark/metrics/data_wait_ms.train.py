"""data layer: the host clock around the fetch of each step's batch
(``PrefetchLoader`` and the native stager, or the pool's index plan), mean
per step of the window."""


def read(ctx):
    waits = ctx.get("spans", {}).get("data_wait")
    if not waits:
        return None
    n = ctx["steps"]
    return 1e3 * sum(waits[-n:]) / n
