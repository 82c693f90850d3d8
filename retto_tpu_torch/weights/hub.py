"""Model acquisition from the HuggingFace Hub.

Copy of ``retto_tpu/weights/hub.py`` (the reference's build-time downloader,
build.rs:7-65, and runtime HfHubHelper, hf_hub_helper.rs:5-19, with the same
artifact set in repo ``pk5ls20/PaddleModel``); :func:`load_ppocr_onnx_engine`
returns the port's ``OnnxEngine`` on ``device``.  ``huggingface_hub`` is
imported when a file is fetched, and a missing package or file, offline
included, raises ``ModelNotFoundError`` with the reason.
"""

from __future__ import annotations

from pathlib import Path

from ..errors import ModelNotFoundError

__all__ = ["PPOCR_V4_FILES", "get_model_file", "fetch_ppocr_v4", "load_ppocr_onnx_engine"]

# build.rs:7-12: the exact artifact list the reference ships with
PPOCR_V4_REPO = "pk5ls20/PaddleModel"
PPOCR_V4_FILES = {
    "det": "retto/onnx/ch_PP-OCRv4_det_infer.onnx",
    "rec": "retto/onnx/ch_PP-OCRv4_rec_infer.onnx",
    "cls": "retto/onnx/ch_ppocr_mobile_v2.0_cls_infer.onnx",
    "keys": "retto/onnx/ppocr_keys_v1.txt",
}


def get_model_file(repo: str, filename: str) -> Path:
    """Download (or hit the local HF cache for) one model file
    (hf_hub_helper.rs:13-18)."""
    try:
        from huggingface_hub import hf_hub_download
    except ImportError as e:
        raise ModelNotFoundError(
            f"huggingface_hub is not installed; cannot fetch {repo}/{filename}"
        ) from e
    try:
        return Path(hf_hub_download(repo, filename))
    except Exception as e:  # noqa: BLE001 - offline, auth, 404 ...
        raise ModelNotFoundError(
            f"failed to fetch {repo}/{filename}: {e}"
        ) from e


def fetch_ppocr_v4(dest: str | Path | None = None) -> dict[str, Path]:
    """Fetch all four PP-OCRv4 artifacts (det/rec/cls/keys) like the
    reference's build script; returns local paths."""
    out = {}
    for key, filename in PPOCR_V4_FILES.items():
        path = get_model_file(PPOCR_V4_REPO, filename)
        if dest is not None:
            import shutil

            d = Path(dest) / Path(filename).name
            d.parent.mkdir(parents=True, exist_ok=True)
            shutil.copy(path, d)
            path = d
        out[key] = path
    return out


def load_ppocr_onnx_engine(device="cuda"):
    """One-call parity path: fetch the reference's PP-OCRv4 ONNX models and
    return (OnnxEngine on ``device``, CharacterDict) ready for
    RettoSession."""
    from ..ops.charset import CharacterDict
    from ..pipeline.onnx_engine import OnnxEngine

    paths = fetch_ppocr_v4()
    engine = OnnxEngine(
        det=paths["det"], cls=paths["cls"], rec=paths["rec"], device=device
    )
    chars = CharacterDict.from_file(paths["keys"])
    return engine, chars
