"""The JAX big-vocab pipeline eval's outcome on the CPU, as the fixture of
``chip_smoke.py``'s eval phase.

Runs ``tools/eval_bigvocab_pipeline.py`` itself at its default 64 lines on
the CPU, records the texts its fused ``run_many`` recognises on each page,
and writes them, the ground truth and the lines the tool prints to
``retto_tpu_torch/testdata/smoke_eval_bigvocab.json``:

    JAX_PLATFORMS=cpu python tests/torch_eval_fixture.py

``tests/test_torch_eval_tools.py`` holds the file's first pages to the
same tool at 8 lines.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
FIXTURE = ROOT / "retto_tpu_torch" / "testdata" / "smoke_eval_bigvocab.json"


def jax_eval_bigvocab(n: int) -> dict:
    """The tool's printed lines and, per page in order, the recognised
    texts of its ``run_many`` calls."""
    from retto_tpu.pipeline.device_pipeline import DevicePipeline

    spec = importlib.util.spec_from_file_location("jax_eval_bigvocab_pipeline",
                                                  ROOT / "tools" / "eval_bigvocab_pipeline.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    pages: list[list[str]] = []
    run_many = DevicePipeline.run_many

    def recording(self, images, *args, **kwargs):
        out = run_many(self, images, *args, **kwargs)
        pages.extend([t.text for t in r.rec_result] for r in out)
        return out

    argv, printed = sys.argv, io.StringIO()
    DevicePipeline.run_many = recording
    sys.argv = ["eval_bigvocab_pipeline.py", str(n)]
    try:
        with contextlib.redirect_stdout(printed):
            tool.main()
    finally:
        DevicePipeline.run_many = run_many
        sys.argv = argv
    return {"n": n, "texts": pages, "printed": printed.getvalue().splitlines()}


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    out = jax_eval_bigvocab(64)
    FIXTURE.write_text(json.dumps(out, ensure_ascii=False, indent=0) + "\n", encoding="utf-8")
    print(f"wrote {FIXTURE} ({len(out['texts'])} pages)")
    print("\n".join(out["printed"][-4 - 12:]))


if __name__ == "__main__":
    main()
