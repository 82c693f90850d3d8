"""CUDA graphs captured inside the window of a closed-loop cell
(``DevicePipeline.compile_count()`` after minus before)."""


def read(ctx: dict):
    return ctx["captures"]
