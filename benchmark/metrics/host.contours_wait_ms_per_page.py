"""Calling-thread milliseconds a page waiting for the det postprocess that
the post pool runs (``DevicePipeline.last_stats["t_contours_wait"]``,
summed over the window's calls, over their pages): what the pool leaves
exposed of ``host.contours_ms_per_page``."""


def read(ctx: dict):
    if not ctx["pages"] or "t_contours_wait" not in ctx["stats"]:
        return None
    return ctx["stats"]["t_contours_wait"] / ctx["pages"] * 1e3
