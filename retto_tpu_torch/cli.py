"""Command-line front end of the port: ``retto-torch``.

Port of ``retto_tpu/cli.py`` (the reference CLI, retto-cli/src/main.rs:
walk a directory of images, run the session on each, report the average
latency) with JAX's flags (cli.py:241-309), plus JSON output and the fused
device pipeline.

Usage:
    retto-torch ocr IMAGES_DIR [--weights-dir trained_weights | --hf-hub] [--json-out out.jsonl]
    retto-torch serve [--host 127.0.0.1] [--port 8471] [--mode compat|performance]
    retto-torch info

``--device`` takes ``cuda`` (the default; ``auto`` means ``cuda``) or
``cpu``, and ``--device-id N`` picks ``cuda:N``.  Without a card the CLI
exits 1 unless ``--device cpu`` is given: it never drops to the CPU by
itself (the JAX CLI takes whatever accelerator JAX finds first,
cli.py:32-59).
"""

from __future__ import annotations

import argparse
import json
import logging
import subprocess
import sys
import time
from pathlib import Path

__all__ = ["main"]

IMAGE_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".webp", ".gif", ".tiff"}


class CliError(Exception):
    """A usage error reported as ``error: ...`` with exit code 1."""


def _device(args) -> str:
    """--device / --device-id -> a torch device string (reference CLI
    surface, main.rs:18-39)."""
    import torch

    if args.device == "cpu":
        return "cpu"
    if not torch.cuda.is_available():
        raise CliError("no CUDA card (torch.cuda.is_available() is False); "
                       "pass --device cpu to run on the CPU")
    n = torch.cuda.device_count()
    if not 0 <= args.device_id < n:
        raise CliError(f"device-id {args.device_id} out of range ({n} devices)")
    return f"cuda:{args.device_id}"


def _build_session(args):
    from .config import PipelineMode, SessionConfig
    from .ops.charset import CharacterDict
    from .pipeline.session import RettoSession

    device = _device(args)
    cfg = SessionConfig()
    if args.transfer:
        cfg.engine.transfer_format = args.transfer
    cfg.mode = PipelineMode(args.mode)
    if getattr(args, "hf_hub", False):
        # reference CLI's use_hf_hub (main.rs:46-66): pull the PP-OCRv4
        # artifact set and run the reference's own models
        from .weights.hub import load_ppocr_onnx_engine

        engine, chars = load_ppocr_onnx_engine(device=device)
        return RettoSession(cfg, engine=engine, charset=chars, device=device)
    if args.limit_side_len:
        cfg.det.limit_side_len = args.limit_side_len
    if args.no_cls:
        cfg.use_cls = False
    charset = None
    weights = None
    wd = Path(args.weights_dir) if args.weights_dir else None
    if wd and (wd / "rec.npz").exists():
        weights = {k: str(wd / f"{k}.npz") for k in ("det", "cls", "rec")}
        cs = wd / "charset.txt"
        if cs.exists():
            charset = CharacterDict(cs.read_text(encoding="utf-8").splitlines())
    if args.charset:
        charset = CharacterDict.from_file(args.charset)
    return RettoSession(cfg, preset=args.preset, charset=charset, weights=weights,
                        device=device)


def cmd_ocr(args) -> int:
    from .errors import RettoError

    root = Path(args.images)
    if root.is_file():
        files = [root]
    else:
        files = sorted(p for p in root.rglob("*") if p.suffix.lower() in IMAGE_EXTS)
    if not files:
        print(f"no images found under {root}", file=sys.stderr)
        return 1
    print(f"Found {len(files)} files, processing...", file=sys.stderr)

    try:
        session = _build_session(args)
    except RettoError as e:
        raise CliError(str(e)) from e
    with session:
        runner = session.device_pipeline() if args.device_pipeline else session
        out_f = open(args.json_out, "w", encoding="utf-8") if args.json_out else None
        n_ok = 0
        t0 = time.perf_counter()

        def emit(f: Path, res) -> None:
            line = {
                "file": str(f),
                "texts": [{"text": t.text, "score": round(t.score, 4)}
                          for t in res.rec_result],
            }
            if args.full:
                line["result"] = res.to_dict()
            if out_f:
                out_f.write(json.dumps(line, ensure_ascii=False) + "\n")
            else:
                print(f"{f.name}: " + " | ".join(t.text for t in res.rec_result))

        if args.device_pipeline:
            n_ok = _ocr_stream(runner, files, max(1, args.batch), emit)
        else:
            for f in files:
                try:
                    res = runner.run(f.read_bytes())
                    n_ok += 1
                except RettoError as e:
                    print(f"{f}: ERROR {e}", file=sys.stderr)
                    continue
                emit(f, res)
        dt = time.perf_counter() - t0
        if out_f:
            out_f.close()
    avg = dt / max(n_ok, 1)
    print(
        f"Successfully processed {n_ok} images, avg time: {avg*1000:.1f} ms "
        f"({n_ok/dt:.2f} images/sec)",
        file=sys.stderr,
    )
    return 0


def _ocr_stream(runner, files: list[Path], bs: int, emit) -> int:
    """Stream file batches through the fused pipeline (cli.py:115-176):
    batch i+1's decode and uploads overlap batch i's postprocess tail.  A
    bad image fills its slot with its error; a batch that fails as a whole
    is redone image by image."""
    from .errors import RettoError

    groups = [files[s : s + bs] for s in range(0, len(files), bs)]
    n_ok = 0
    emitted: set[Path] = set()
    try:
        for group, results in zip(
            groups, runner.stream([[f.read_bytes() for f in g] for g in groups])
        ):
            for f, res in zip(group, results):
                emitted.add(f)
                if isinstance(res, RettoError):
                    print(f"{f}: ERROR {res}", file=sys.stderr)
                    continue
                emit(f, res)
                n_ok += 1
    except RettoError:
        for f in (f for g in groups for f in g if f not in emitted):
            try:
                res = runner.run(f.read_bytes())
            except RettoError as e:
                print(f"{f}: ERROR {e}", file=sys.stderr)
                continue
            emit(f, res)
            n_ok += 1
    return n_ok


def cmd_serve(args) -> int:
    from .serve import serve

    with _build_session(args) as session:
        serve(session, args.host, args.port, max_batch=args.max_batch,
              max_wait_ms=args.max_wait_ms)
    return 0


def cmd_info(args) -> int:
    import torch

    from . import __version__, kernels

    device = _device(args)
    print(f"retto-tpu-torch {__version__}")
    print(f"torch {torch.__version__}; CUDA {torch.version.cuda}; device {device}")
    if device == "cpu":
        print("kernels: not built (the CPU runs each kernel's plain PyTorch version)")
        return 0
    idx = torch.device(device).index or 0
    smi = subprocess.run(
        ["nvidia-smi", f"--id={idx}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
    )
    print(f"card: {torch.cuda.get_device_name(idx)}; nvidia-smi: "
          f"{smi.stdout.strip() or smi.stderr.strip()}")
    t = time.perf_counter()
    try:
        kernels.load()
    except Exception as e:  # noqa: BLE001 - report, do not crash
        print(f"kernels: build failed: {e}")
        return 1
    print(f"kernels: built and loaded in {time.perf_counter() - t:.2f} s")
    return 0


def _device_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda", choices=["cuda", "auto", "cpu"],
                   help="cuda (default; auto means cuda) or cpu (reference: --device)")
    p.add_argument("--device-id", type=int, default=0,
                   help="card ordinal, cuda:N (reference: --device-id)")


def _session_flags(p: argparse.ArgumentParser) -> None:
    _device_flags(p)
    p.add_argument("--weights-dir", default="trained_weights")
    p.add_argument("--charset", default=None, help="character dict file")
    p.add_argument("--preset", default="mobile", choices=["tiny", "mobile", "server"])
    p.add_argument("--mode", default="performance", choices=["compat", "performance"])
    p.add_argument("--transfer", default=None, choices=["rgb", "yuv420"],
                   help="host->device image transfer format")
    p.add_argument("--limit-side-len", type=int, default=None)
    p.add_argument("--no-cls", action="store_true")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="retto-torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    ocr = sub.add_parser("ocr", help="run OCR over a file or directory")
    ocr.add_argument("images", help="image file or directory")
    _session_flags(ocr)
    ocr.add_argument("--device-pipeline", action="store_true",
                     help="use the fused device-resident fast path")
    ocr.add_argument("--batch", type=int, default=16,
                     help="files per run_many batch (with --device-pipeline)")
    ocr.add_argument("--hf-hub", action="store_true",
                     help="run the reference's PP-OCRv4 ONNX artifacts from the "
                          "HuggingFace Hub cache (reference: use_hf_hub)")
    ocr.add_argument("--json-out", default=None, help="write JSONL results")
    ocr.add_argument("--full", action="store_true",
                     help="include boxes/labels in JSON output")
    ocr.add_argument("-v", "--verbose", action="store_true")
    ocr.set_defaults(fn=cmd_ocr)

    info = sub.add_parser("info", help="versions, the card and the kernel build")
    _device_flags(info)
    info.set_defaults(fn=cmd_info)

    srv = sub.add_parser("serve", help="HTTP OCR server (NDJSON streaming)")
    srv.add_argument("--host", default="127.0.0.1")
    srv.add_argument("--port", type=int, default=8471)
    srv.add_argument("--max-batch", type=int, default=16,
                     help="micro-batch size for concurrent /ocr requests")
    srv.add_argument("--max-wait-ms", type=float, default=5.0,
                     help="micro-batch gather window")
    _session_flags(srv)
    srv.set_defaults(fn=cmd_serve)

    args = ap.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if getattr(args, "verbose", False) else logging.INFO
    )
    try:
        return args.fn(args)
    except CliError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
