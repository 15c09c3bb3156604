"""train step layer: 3 x the forward's FLOPs (the benchmark's own count on
the plain model) x the images stepped, over the window, against the card's
bf16 peak (``harness/peaks.json``; the power limit is on the run's
standard error)."""


def read(ctx):
    if not ctx.get("items"):
        return None
    flops = 3.0 * ctx["counts"]["forward_flops"] * ctx["items"]
    return 100.0 * flops / ctx["window_s"] / ctx["peaks"]["bf16_flops"]
