"""The SSD scan forward kernel's share of its roofline, in %: the least
time of one scan of every pass's rows in every layer, counted from the
plan, over the device time of every launch of the kernel in the traced
steps, recomputes included."""

from perfbench.roofline import peaks, ssd


def pick(name):
    return "ssd_scan_kernel" in name.lower()


def read(ctx):
    m = ctx.config["model"]
    if not m.get("ssm_state"):
        return None
    heads = m["ssm_expand"] * m["d_model"] // m["ssm_head_dim"]
    least = sum(peaks.least_seconds(*ssd.forward(
        (rows, heads, ctx.seq, m["ssm_head_dim"], m["ssm_state"]),
        ctx.esize), ctx.peaks) for rows in ctx.passes) * m["n_layers"]
    return ctx.share_of_bound(pick, least)
