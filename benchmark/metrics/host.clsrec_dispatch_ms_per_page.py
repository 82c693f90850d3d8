"""Calling-thread milliseconds a page dispatching cls + rec buckets: the
crops' geometry, its uploads and the graph replays
(``DevicePipeline.last_stats["t_clsrec_dispatch"]``, summed over the
window's calls, over their pages)."""


def read(ctx: dict):
    if not ctx["pages"] or "t_clsrec_dispatch" not in ctx["stats"]:
        return None
    return ctx["stats"]["t_clsrec_dispatch"] / ctx["pages"] * 1e3
