"""Percent of the profiled sub-window of a closed-loop cell in which no
kernel or memory copy ran on the card (1 - the union of their intervals
over the window)."""


def read(ctx: dict):
    tr = ctx.get("trace")
    if tr is None:
        return None
    return (1.0 - tr.busy_s / tr.window_s) * 100.0
