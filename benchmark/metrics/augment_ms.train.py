"""augment layer: CUDA events around each ``jitted_augment()`` call (with
its ``draw``), mean per step of the window."""


def read(ctx):
    ms = ctx.get("events", {}).get("augment")
    return sum(ms) / len(ms) if ms else None
