"""decode layer: K3 (``decode_levels_tma``, whose device function is
``decode_levels_kernel``)'s share of its roofline in the traced window:
every fp32 value of the head's maps read once and every decoded row written
once (``harness/counts.k3_bytes``) over the card's bandwidth, against the
kernel's device time."""
import re

NAME = re.compile(r"(^|[^A-Za-z0-9_])decode_levels_kernel([^A-Za-z0-9_]|$)")


def read(ctx):
    t = ctx.get("trace")
    if not t:
        return None
    hits = [v for n, v in t["kernels"].items() if NAME.search(n)]
    secs, launches = sum(v[0] for v in hits), sum(v[1] for v in hits)
    if not launches or secs <= 0:
        return None
    bound = launches * ctx["counts"]["k3_bytes"] / ctx["peaks"]["hbm_bytes_s"]
    return 100.0 * bound / secs
