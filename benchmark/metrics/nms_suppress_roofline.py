"""nms layer: K1 (``nms_suppress``, whose device function is
``nms_suppress_kernel``)'s share of its roofline in the traced window: the
larger of 13 fp32 operations an IoU test these inputs need (pairs of valid
candidates of one class, counted by the reference on the same batches) over
the fp32 peak, and its inputs read and keep-mask written once over the
bandwidth, against the kernel's device time."""
import re

NAME = re.compile(r"(^|[^A-Za-z0-9_])nms_suppress_kernel([^A-Za-z0-9_]|$)")


def read(ctx):
    t = ctx.get("trace")
    if not t:
        return None
    hits = [v for n, v in t["kernels"].items() if NAME.search(n)]
    secs, launches = sum(v[0] for v in hits), sum(v[1] for v in hits)
    if not launches or secs <= 0:
        return None
    c, p = ctx["counts"], ctx["peaks"]
    bound = max(13.0 * c["k1_pair_tests"] / p["fp32_flops"], c["k1_bytes"] / p["hbm_bytes_s"])
    return 100.0 * launches * bound / secs
