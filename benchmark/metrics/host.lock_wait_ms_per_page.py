"""Milliseconds a page that the pipeline's threads wait for its dispatch
lock, summed over the threads (``DevicePipeline.last_stats["t_lock_wait"]``,
summed over the window's calls, over their pages)."""


def read(ctx: dict):
    if not ctx["pages"] or "t_lock_wait" not in ctx["stats"]:
        return None
    return ctx["stats"]["t_lock_wait"] / ctx["pages"] * 1e3
