"""The whole step's share of the card's dense bf16 peak, in percent: the
FLOPs the window's pages need (``benchmark.flops``: det at each page's det
input size, cls and rec at each crop's width, no padding) over the window's
wall time times the peak (``benchmark.flops.PEAKS``)."""


def read(ctx: dict):
    if "peak_flops" not in ctx or not ctx.get("flops"):
        return None
    return ctx["flops"] / (ctx["wall"] * ctx["peak_flops"]) * 100.0
