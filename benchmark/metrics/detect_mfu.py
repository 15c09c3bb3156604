"""request layer: the forward's FLOPs (the benchmark's own count on the
plain model) x the images detected, over the window, against the card's
bf16 peak."""


def read(ctx):
    if not ctx.get("items"):
        return None
    flops = ctx["counts"]["forward_flops"] * ctx["items"]
    return 100.0 * flops / ctx["window_s"] / ctx["peaks"]["bf16_flops"]
