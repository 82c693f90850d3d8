"""Host milliseconds a page in the det postprocess on the calling thread
(``DevicePipeline.last_stats["t_contours"]``, summed over the window's
calls, over their pages)."""


def read(ctx: dict):
    if not ctx["pages"] or "t_contours" not in ctx["stats"]:
        return None
    return ctx["stats"]["t_contours"] / ctx["pages"] * 1e3
