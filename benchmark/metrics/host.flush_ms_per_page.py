"""Calling-thread milliseconds a page in the crop accumulator's flush: the
chunks' pad + concat and the crops' bucketing, the lock's wait excluded
(``DevicePipeline.last_stats["t_flush"]``, summed over the window's calls,
over their pages)."""


def read(ctx: dict):
    if not ctx["pages"] or "t_flush" not in ctx["stats"]:
        return None
    return ctx["stats"]["t_flush"] / ctx["pages"] * 1e3
