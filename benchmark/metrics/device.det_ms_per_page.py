"""Card milliseconds a page in the det stage: CUDA timing events around
each det graph replay and its input copies
(``DevicePipeline.last_stats["t_det_device"]``, summed over the window's
calls, over their pages).  Absent on a CPU device."""


def read(ctx: dict):
    if not ctx["pages"] or "t_det_device" not in ctx["stats"]:
        return None
    return ctx["stats"]["t_det_device"] / ctx["pages"] * 1e3
