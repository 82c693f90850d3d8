"""The det epilogue kernel's share of its roofline, in percent: the bytes
the profiled pages' det maps need it to move (``benchmark.flops.
epilogue_bytes``: the logits read once, the packed mask and pooled prob map
written once) at the card's HBM rate, over the device time of its
``db_epilogue`` kernels in the trace."""


def read(ctx: dict):
    tr = ctx.get("trace")
    if tr is None or not tr.epilogue_launches or "epilogue_bytes" not in ctx \
            or "peak_bytes" not in ctx:
        return None
    return ctx["epilogue_bytes"] / ctx["peak_bytes"] / tr.epilogue_s * 100.0
