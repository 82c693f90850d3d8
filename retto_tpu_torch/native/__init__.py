"""Native (C++) postprocess backend.

Port copy of ``retto_tpu/native/__init__.py``: the port imports nothing of the JAX
package, so it keeps its own copy of this host-only module.  The port adds
``conv_xla_native``, ``dot_xla_native`` and ``rsqrt_xla_native``
(``conv_xla.cpp``): the convolution, the dot and the rsqrt in XLA:CPU's
arithmetic, which ``models.common`` uses on CPU tensors; and
``gray_batch_native`` and ``pack_chunk_native``: the gray probe of many
pages, and a det chunk's stacked upload planes, each one call threaded
over the pages (``DevicePipeline._prepare``, ``_upload_and_det``).

Compiled lazily with g++ at first use (no pybind11 in this environment;
plain C ABI + ctypes).  Falls back silently to the NumPy implementation
when no compiler is available — ``available()`` reports which backend is
active.  Force with RETTO_NATIVE=0/1.
"""

from __future__ import annotations

import contextlib
import ctypes
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Any, Sequence

import numpy as np

logger = logging.getLogger("retto_tpu_torch.native")

_HERE = Path(__file__).parent
_LIB: ctypes.CDLL | None = None
_TRIED = False
_LOAD_LOCK = threading.Lock()  # one build; no thread reads a half-made _LIB


def _build_lib() -> Path | None:
    """g++ build into ``.torch_build/`` (the JAX package builds the same
    source into the temp dir; the port keeps its build inside the checkout)."""
    from .._build import build_shared

    try:
        return build_shared(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread"],
            [_HERE / "postprocess.cpp", _HERE / "conv_xla.cpp"], "libretto_post.so",
            timeout=120,
        )
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        logger.warning("native postprocess build failed (%s); using numpy", e)
        return None


@contextlib.contextmanager
def switched_off():
    """Within the block the library reads as absent, so every caller takes
    its torch or numpy fallback: the port's CPU convs then run as torch
    ops, which torch's FLOP counter sees (the probes' counts on the CPU)."""
    global _LIB, _TRIED
    saved = _LIB, _TRIED
    _LIB, _TRIED = None, True
    try:
        yield
    finally:
        _LIB, _TRIED = saved


def _load() -> ctypes.CDLL | None:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    with _LOAD_LOCK:
        if not _TRIED:
            _LIB = _open()
            _TRIED = True
    return _LIB


def _open() -> ctypes.CDLL | None:
    if os.environ.get("RETTO_NATIVE") == "0":
        return None
    path = _build_lib()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.rt_det_candidates.restype = ctypes.c_int
    lib.rt_det_candidates.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
    ]
    lib.rt_det_candidates_batch.restype = ctypes.c_int
    lib.rt_det_candidates_batch.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),  # packed [b, ph, pw]
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # b, ph, pw
        ctypes.c_int,  # row_packed
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int, ctypes.c_int,  # min_mini_box_size, max_candidates
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int,  # max_boxes_per_img
    ]
    lib.rt_conv_xla.restype = ctypes.c_int
    lib.rt_conv_xla.argtypes = [ctypes.POINTER(ctypes.c_float)] * 3 + [ctypes.c_int] * 15
    lib.rt_dot_xla.restype = ctypes.c_int
    lib.rt_dot_xla.argtypes = [ctypes.POINTER(ctypes.c_float)] * 3 + [ctypes.c_int] * 6
    lib.rt_rsqrt_xla.restype = None
    lib.rt_rsqrt_xla.argtypes = [ctypes.POINTER(ctypes.c_float)] * 2 + [ctypes.c_int]
    lib.rt_is_gray.restype = ctypes.c_int
    lib.rt_is_gray.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
    lib.rt_det_chunk.restype = ctypes.c_int
    lib.rt_det_chunk.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),  # packed [b, ph, pw]
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # b,ph,pw,row_packed
        ctypes.POINTER(ctypes.c_uint8),  # prob4 [b, p4h, p4w]
        ctypes.c_int, ctypes.c_int,  # p4h, p4w
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),  # mhs, mws
        ctypes.c_int,  # stride
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),  # rhs, rws
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),  # ahs, aws
        ctypes.c_int, ctypes.c_int,  # min_sside, max_candidates
        ctypes.c_double, ctypes.c_double, ctypes.c_int,  # box_thresh, unclip, min_box
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int,  # max_boxes_per_img
    ]
    lib.rt_det_finalize.restype = ctypes.c_int
    lib.rt_det_finalize.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
    ]
    lib.rt_det_postprocess.restype = ctypes.c_int
    lib.rt_det_postprocess.argtypes = [
        ctypes.POINTER(ctypes.c_float),  # pred
        ctypes.POINTER(ctypes.c_uint8),  # mask
        ctypes.c_int, ctypes.c_int,  # h, w
        ctypes.c_double, ctypes.c_double,  # box_thresh, unclip_ratio
        ctypes.c_int, ctypes.c_int,  # min_mini_box_size, max_candidates
        ctypes.c_int, ctypes.c_int,  # dest_h, dest_w
        ctypes.POINTER(ctypes.c_float),  # out_boxes
        ctypes.POINTER(ctypes.c_float),  # out_scores
        ctypes.c_int,  # max_boxes
    ]
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.rt_pack_yuv420.restype = ctypes.c_int
    lib.rt_pack_yuv420.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        u8p, u8p,
    ]
    lib.rt_pack_gray.restype = ctypes.c_int
    lib.rt_pack_gray.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p,
    ]
    if hasattr(lib, "rt_pack_auto"):  # stale cached .so from an older src
        lib.rt_pack_auto.restype = ctypes.c_int
        lib.rt_pack_auto.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            u8p, u8p,
        ]
    if hasattr(lib, "rt_pack_chunk"):
        lib.rt_gray_batch.restype = ctypes.c_int
        lib.rt_gray_batch.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
        ]
        lib.rt_pack_chunk.restype = ctypes.c_int
        lib.rt_pack_chunk.argtypes = [
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),  # hs, ws
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # n, nb, hp, wp
            ctypes.c_int, ctypes.c_int,  # yuv, threads
            u8p, u8p,
        ]
    return lib


def available() -> bool:
    return _load() is not None


def det_postprocess_native(
    pred: np.ndarray,
    mask: np.ndarray,
    box_thresh: float,
    unclip_ratio: float,
    min_mini_box_size: int,
    max_candidates: int,
    dest_h: int,
    dest_w: int,
    max_boxes: int = 1024,
) -> tuple[np.ndarray, np.ndarray] | None:
    """Fused C++ det postprocess; None when the native lib is unavailable."""
    lib = _load()
    if lib is None:
        return None
    pred = np.ascontiguousarray(pred, np.float32)
    mask_u8 = np.ascontiguousarray(mask, np.uint8)
    h, w = pred.shape
    boxes = np.zeros((max_boxes, 4, 2), np.float32)
    scores = np.zeros((max_boxes,), np.float32)
    n = lib.rt_det_postprocess(
        pred.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        mask_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h, w,
        float(box_thresh), float(unclip_ratio),
        int(min_mini_box_size), int(max_candidates),
        int(dest_h), int(dest_w),
        boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_boxes,
    )
    return boxes[:n].copy(), scores[:n].copy()


def det_candidates_native(
    mask: np.ndarray, min_mini_box_size: int, max_candidates: int,
    max_boxes: int = 1024,
) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    mask_u8 = np.ascontiguousarray(mask, np.uint8)
    h, w = mask_u8.shape
    boxes = np.zeros((max_boxes, 4, 2), np.float32)
    n = lib.rt_det_candidates(
        mask_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
        int(min_mini_box_size), int(max_candidates),
        boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_boxes,
    )
    return boxes[:n].copy()


def det_finalize_native(
    cand_boxes: np.ndarray, cand_scores: np.ndarray,
    box_thresh: float, unclip_ratio: float, min_mini_box_size: int,
    bitmap_h: int, bitmap_w: int, dest_h: int, dest_w: int,
    max_boxes: int = 1024,
) -> tuple[np.ndarray, np.ndarray] | None:
    lib = _load()
    if lib is None:
        return None
    cb = np.ascontiguousarray(cand_boxes, np.float32)
    cs = np.ascontiguousarray(cand_scores, np.float32)
    boxes = np.zeros((max_boxes, 4, 2), np.float32)
    scores = np.zeros((max_boxes,), np.float32)
    n = lib.rt_det_finalize(
        cb.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        cs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(cb),
        float(box_thresh), float(unclip_ratio), int(min_mini_box_size),
        int(bitmap_h), int(bitmap_w), int(dest_h), int(dest_w),
        boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_boxes,
    )
    return boxes[:n].copy(), scores[:n].copy()


def det_candidates_batch_native(
    packed: np.ndarray,
    heights,
    widths,
    row_packed: bool,
    min_mini_box_size: int,
    max_candidates: int,
    max_boxes: int = 1024,
) -> list[np.ndarray] | None:
    """Candidates for a whole det chunk straight from the packed 1-bit
    masks (no numpy unpack, one GIL-released call — the DevicePipeline hot
    phase on the single-core host).  packed: [b, ph, pw] u8; layout per
    ``row_packed`` (ops.pallas.db_pack vs ops.db_post).  Returns one
    [n_i, 4, 2] float32 array per image, or None without a compiler."""
    lib = _load()
    if lib is None:
        return None
    packed = np.ascontiguousarray(packed, np.uint8)
    b, ph, pw = packed.shape
    hs = np.ascontiguousarray(heights, np.int32)
    ws = np.ascontiguousarray(widths, np.int32)
    boxes = np.zeros((b, max_boxes, 4, 2), np.float32)
    counts = np.zeros((b,), np.int32)
    lib.rt_det_candidates_batch(
        packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        b, ph, pw, int(bool(row_packed)),
        hs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ws.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        int(min_mini_box_size), int(max_candidates),
        boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        max_boxes,
    )
    return [boxes[k, : counts[k]].copy() for k in range(b)]


def det_chunk_native(
    packed: np.ndarray,
    row_packed: bool,
    prob4: np.ndarray,
    mask_sizes,  # [(mh, mw)] per image (det/stride)
    stride: int,
    bitmap_sizes,  # [(rh, rw)] det-res sizes
    dest_sizes,  # [(ah, aw)] session sizes
    min_sside: int,
    max_candidates: int,
    box_thresh: float,
    unclip_ratio: float,
    min_mini_box_size: int,
    max_boxes: int = 1024,
) -> list[tuple[np.ndarray, np.ndarray]] | None:
    """Whole det-chunk postprocess (contours + pooled-map scoring +
    finalize) in one GIL-released call; returns [(boxes, scores)] per image
    in session coords, or None without a compiler."""
    lib = _load()
    if lib is None or not hasattr(lib, "rt_det_chunk"):
        return None
    packed = np.ascontiguousarray(packed, np.uint8)
    prob4 = np.ascontiguousarray(prob4, np.uint8)
    b, ph, pw = packed.shape
    _, p4h, p4w = prob4.shape
    mhs = np.ascontiguousarray([m[0] for m in mask_sizes], np.int32)
    mws = np.ascontiguousarray([m[1] for m in mask_sizes], np.int32)
    rhs = np.ascontiguousarray([r[0] for r in bitmap_sizes], np.int32)
    rws = np.ascontiguousarray([r[1] for r in bitmap_sizes], np.int32)
    ahs = np.ascontiguousarray([d[0] for d in dest_sizes], np.int32)
    aws = np.ascontiguousarray([d[1] for d in dest_sizes], np.int32)
    boxes = np.zeros((b, max_boxes, 4, 2), np.float32)
    scores = np.zeros((b, max_boxes), np.float32)
    counts = np.zeros((b,), np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.rt_det_chunk(
        packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        b, ph, pw, int(bool(row_packed)),
        prob4.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        p4h, p4w,
        mhs.ctypes.data_as(i32p), mws.ctypes.data_as(i32p),
        int(stride),
        rhs.ctypes.data_as(i32p), rws.ctypes.data_as(i32p),
        ahs.ctypes.data_as(i32p), aws.ctypes.data_as(i32p),
        int(min_sside), int(max_candidates),
        float(box_thresh), float(unclip_ratio), int(min_mini_box_size),
        boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        counts.ctypes.data_as(i32p),
        max_boxes,
    )
    return [
        (boxes[k, : counts[k]].copy(), scores[k, : counts[k]].copy())
        for k in range(b)
    ]


def pack_yuv420_native(
    img: np.ndarray, hp: int, wp: int
) -> tuple[np.ndarray, np.ndarray] | None:
    """Edge-replicate pad to (hp, wp) + planar YUV 4:2:0 pack in ONE pass
    (Y bit-exact with PIL convert('L'); chroma within +-1 of the PIL
    BOX+YCbCr chain).  None without a compiler."""
    lib = _load()
    if lib is None or not hasattr(lib, "rt_pack_yuv420"):
        return None
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    if c != 3 or hp % 2 or wp % 2:
        return None
    y = np.empty((hp, wp), np.uint8)
    uv = np.empty((hp // 2, wp // 2, 2), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    rc = lib.rt_pack_yuv420(
        img.ctypes.data_as(u8p), h, w, hp, wp,
        y.ctypes.data_as(u8p), uv.ctypes.data_as(u8p),
    )
    if rc != 0:
        return None
    return y, uv


def pack_gray_native(img: np.ndarray, hp: int, wp: int) -> np.ndarray | None:
    """Edge-replicate pad + channel-0 extract in one pass (the lossless
    1 B/px transfer for truly-grayscale inputs).  None without a compiler."""
    lib = _load()
    if lib is None or not hasattr(lib, "rt_pack_gray"):
        return None
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    if c != 3:
        return None
    out = np.empty((hp, wp), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.rt_pack_gray(img.ctypes.data_as(u8p), h, w, hp, wp,
                     out.ctypes.data_as(u8p))
    return out


def pack_auto_native(
    img: np.ndarray, hp: int, wp: int
) -> tuple[bool, np.ndarray, np.ndarray] | None:
    """Grayness probe + YUV 4:2:0 pack fused into ONE read of the source
    (the decode hot path previously scanned the image twice).  Returns
    (is_gray, y, uv): if is_gray, ``y`` is the lossless 1 B/px gray plane
    (Y of R==G==B is bit-exactly the channel value) and ``uv`` should be
    discarded; else (y, uv) is the standard YUV 4:2:0 transfer.  None
    without a compiler or on odd-padded extents."""
    lib = _load()
    if lib is None or not hasattr(lib, "rt_pack_auto"):
        return None
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    if c != 3 or hp % 2 or wp % 2:
        return None
    y = np.empty((hp, wp), np.uint8)
    uv = np.empty((hp // 2, wp // 2, 2), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    rc = lib.rt_pack_auto(
        img.ctypes.data_as(u8p), h, w, hp, wp,
        y.ctypes.data_as(u8p), uv.ctypes.data_as(u8p),
    )
    if rc < 0:
        return None
    return bool(rc), y, uv


def _rgb_pages(imgs) -> tuple[list[np.ndarray], Any] | None:
    """Contiguous [h, w, 3] u8 pages and a C array of their addresses (the
    list keeps the pages alive while the array is in use); None if a page
    has another shape."""
    pages = [np.ascontiguousarray(a, np.uint8) for a in imgs]
    if any(a.ndim != 3 or a.shape[2] != 3 for a in pages):
        return None
    return pages, (ctypes.c_void_p * len(pages))(*[a.ctypes.data for a in pages])


def gray_batch_native(imgs: Sequence[np.ndarray], threads: int) -> list[bool] | None:
    """R==G==B for each interleaved HWC u8 page (``is_gray_native``, the
    format ``pack_auto_native`` reports), in one GIL-released call over
    ``threads`` native threads.  ``[]`` for no pages; None without a
    compiler or for a page that is not [h, w, 3]."""
    lib = _load()
    if lib is None or not hasattr(lib, "rt_gray_batch"):
        return None
    if not imgs:
        return []
    got = _rgb_pages(imgs)
    if got is None:
        return None
    pages, ptrs = got
    n_px = np.asarray([a.shape[0] * a.shape[1] for a in pages], np.int64)
    out = np.zeros(len(pages), np.int32)
    lib.rt_gray_batch(ptrs, n_px.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                      len(pages), int(threads),
                      out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return [bool(v) for v in out]


def pack_chunk_native(
    imgs: Sequence[np.ndarray], hp: int, wp: int, nb: int, gray: bool, threads: int,
) -> tuple[np.ndarray, ...] | None:
    """A det chunk's stacked upload planes in one GIL-released call over
    ``threads`` native threads: page k edge-padded to (hp, wp) in row k,
    rows ``len(imgs)``..``nb - 1`` zero.  ``gray``: ``(y [nb, hp, wp],)``,
    each row ``pack_gray_native``'s plane; else ``(y, uv [nb, hp/2, wp/2,
    2])``, each row ``pack_auto_native``'s.  None without a compiler, for
    odd hp/wp, or for a page that is not [h, w, 3] within (hp, wp)."""
    lib = _load()
    if lib is None or not hasattr(lib, "rt_pack_chunk"):
        return None
    got = _rgb_pages(imgs)
    if (got is None or hp % 2 or wp % 2 or not 0 < len(imgs) <= nb
            or any(a.shape[0] > hp or a.shape[1] > wp for a in got[0])):
        return None
    pages, ptrs = got
    hs = np.asarray([a.shape[0] for a in pages], np.int32)
    ws = np.asarray([a.shape[1] for a in pages], np.int32)
    y = np.empty((nb, hp, wp), np.uint8)
    uv = None if gray else np.empty((nb, hp // 2, wp // 2, 2), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.rt_pack_chunk(ptrs, hs.ctypes.data_as(i32p), ws.ctypes.data_as(i32p),
                      len(pages), nb, hp, wp, int(not gray), int(threads),
                      y.ctypes.data_as(u8p), None if uv is None else uv.ctypes.data_as(u8p))
    return (y,) if uv is None else (y, uv)


def is_gray_native(img: np.ndarray) -> bool | None:
    """One-pass R==G==B test for an interleaved HWC u8 image (the
    DevicePipeline transfer-format probe); None without a compiler."""
    lib = _load()
    if lib is None or not hasattr(lib, "rt_is_gray"):
        return None
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    if c != 3:
        return None
    return bool(
        lib.rt_is_gray(
            img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int64(h * w),
        )
    )


def conv_xla_native(
    x: np.ndarray, w: np.ndarray, stride: tuple[int, int], pads: tuple[int, int],
    out_hw: tuple[int, int], kc: int, threads: int,
) -> np.ndarray | None:
    """float32 conv in XLA:CPU's summation order (``conv_xla.cpp``):
    ``x`` NHWC, ``w`` HWIO, ``pads`` (top, left); None without the library."""
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    w = np.ascontiguousarray(w, np.float32)
    n, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape
    out = np.empty((n, *out_hw, cout), np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    err = lib.rt_conv_xla(x.ctypes.data_as(fp), w.ctypes.data_as(fp), out.ctypes.data_as(fp),
                          n, h, wd, cin, kh, kw, cout, stride[0], stride[1], pads[0], pads[1],
                          out_hw[0], out_hw[1], kc, threads)
    return None if err else out


def dot_xla_native(a: np.ndarray, w: np.ndarray, lanes: int, block: int,
                   threads: int) -> np.ndarray | None:
    """float32 [m, k] x [k, n] in one of XLA:CPU's summation orders
    (``conv_xla.cpp``: ``lanes`` interleaved partial sums added pairwise,
    within blocks of ``block`` terms added in order); None without the
    library."""
    lib = _load()
    if lib is None:
        return None
    a = np.ascontiguousarray(a, np.float32)
    w = np.ascontiguousarray(w, np.float32)
    (m, k), n = a.shape, w.shape[1]
    if w.shape[0] != k:
        raise ValueError(f"dot of {a.shape} and {w.shape}")
    out = np.empty((m, n), np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    err = lib.rt_dot_xla(a.ctypes.data_as(fp), w.ctypes.data_as(fp), out.ctypes.data_as(fp),
                         m, k, n, lanes, block, threads)
    return None if err else out


def rsqrt_xla_native(x: np.ndarray) -> np.ndarray | None:
    """float32 ``rsqrt`` as XLA:CPU computes it (``conv_xla.cpp``); None
    without the library."""
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    out = np.empty_like(x)
    fp = ctypes.POINTER(ctypes.c_float)
    lib.rt_rsqrt_xla(x.ctypes.data_as(fp), out.ctypes.data_as(fp), x.size)
    return out
