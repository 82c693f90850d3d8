"""Upload-thread milliseconds a page outside the dispatch lock's wait: the
chunks' stacking, uploads, det replay, clone and the det maps' copies
enqueued (``DevicePipeline.last_stats["t_upload"]``, summed over the
window's calls, over their pages)."""


def read(ctx: dict):
    if not ctx["pages"] or "t_upload" not in ctx["stats"]:
        return None
    return ctx["stats"]["t_upload"] / ctx["pages"] * 1e3
