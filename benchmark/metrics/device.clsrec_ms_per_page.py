"""Card milliseconds a page in the cls + rec stage: CUDA timing events
around each cls + rec graph replay and its input copies
(``DevicePipeline.last_stats["t_clsrec_device"]``, summed over the
window's calls, over their pages).  Absent on a CPU device."""


def read(ctx: dict):
    if not ctx["pages"] or "t_clsrec_device" not in ctx["stats"]:
        return None
    return ctx["stats"]["t_clsrec_device"] / ctx["pages"] * 1e3
