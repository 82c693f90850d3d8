"""Calling-thread milliseconds a page blocked on the upload thread, the
fetch threads or the card: ``t_upload_wait + t_mask_fetch + t_clsrec_wait``
of ``DevicePipeline.last_stats``, summed over the window's calls, over
their pages."""

KEYS = ("t_upload_wait", "t_mask_fetch", "t_clsrec_wait")


def read(ctx: dict):
    if not ctx["pages"] or any(k not in ctx["stats"] for k in KEYS):
        return None
    return sum(ctx["stats"][k] for k in KEYS) / ctx["pages"] * 1e3
