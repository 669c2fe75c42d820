"""The flash attention backward kernels' (dq, then dk and dv) share of
their roofline, in %: the least time of one causal backward of every
pass's rows in every layer, counted from the plan, over the device time
of every launch of the two kernels in the traced steps."""

from perfbench.roofline import flash, peaks


def pick(name):
    return "flash_bwd_" in name.lower()


def read(ctx):
    m = ctx.config["model"]
    if not m.get("n_heads"):
        return None
    least = sum(peaks.least_seconds(*flash.backward(
        (rows, m["n_heads"], m["n_kv_heads"], ctx.seq, ctx.seq,
         m["head_dim"], True, 0), ctx.esize), ctx.peaks)
        for rows in ctx.passes) * m["n_layers"]
    return ctx.share_of_bound(pick, least)
