"""Host milliseconds a page in decode + pack (``DevicePipeline.last_stats
["t_decode"]``, summed over the window's calls, over their pages)."""


def read(ctx: dict):
    if not ctx["pages"] or "t_decode" not in ctx["stats"]:
        return None
    return ctx["stats"]["t_decode"] / ctx["pages"] * 1e3
