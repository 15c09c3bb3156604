"""train step layer: CUDA events around each ``jitted_train_step()`` call,
mean per step of the window."""


def read(ctx):
    ms = ctx.get("events", {}).get("train_step")
    return sum(ms) / len(ms) if ms else None
