"""Device probes of the port: the per-layer accounting of the JAX package's
``tools/stage_probe.py``, ``tools/det_probe.py`` and ``tools/clsrec_probe.py``
on PyTorch.

    python -m retto_tpu_torch.tools.stage_probe [yuv420|rgb] [--device cuda|cpu]
    python -m retto_tpu_torch.tools.det_probe [--batch 8] [--h 1024] [--w 768]
    python -m retto_tpu_torch.tools.clsrec_probe [--n 32] [--iters 30]

Each module's ``measure(...)`` returns its rows (:class:`~._common.Row`:
label, best and median ms of warm calls, FLOPs, MFU) and ``main(argv)``
prints them under the card's name and power limit; ``chip_smoke.py`` calls
``measure`` in-process (phase probes).
"""
