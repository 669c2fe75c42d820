"""The flash attention forward kernel's share of its roofline, in %: the
least time of one causal forward of every pass's rows in every layer (the
work a step needs, counted from the plan), over the device time of every
launch of the kernel in the traced steps, recomputes included."""

from perfbench.roofline import flash, peaks


def pick(name):
    return "flash_fwd_kernel" in name.lower()


def read(ctx):
    m = ctx.config["model"]
    if not m.get("n_heads"):
        return None
    least = sum(peaks.least_seconds(*flash.forward(
        (rows, m["n_heads"], m["n_kv_heads"], ctx.seq, ctx.seq,
         m["head_dim"], True, 0), ctx.esize), ctx.peaks)
        for rows in ctx.passes) * m["n_layers"]
    return ctx.share_of_bound(pick, least)
