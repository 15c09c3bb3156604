"""data layer: ``stage_letterbox`` (device function ``stage_letterbox_kernel``)'s
share of its roofline in the traced window: the decoded bytes of every tile
read once and every canvas written once (``harness/counts.stage_letterbox_bytes``)
over the card's bandwidth, against the kernel's device time. Nothing to read
in a cell whose batches come from the device pool."""
import re

NAME = re.compile(r"(^|[^A-Za-z0-9_])stage_letterbox_kernel([^A-Za-z0-9_]|$)")


def read(ctx):
    t = ctx.get("trace")
    if not t:
        return None
    hits = [v for n, v in t["kernels"].items() if NAME.search(n)]
    secs, launches = sum(v[0] for v in hits), sum(v[1] for v in hits)
    if not launches or secs <= 0:
        return None
    bound = launches * ctx["counts"]["stage_letterbox_bytes"] / ctx["peaks"]["hbm_bytes_s"]
    return 100.0 * bound / secs
