"""Device-resident fused pipeline (PERFORMANCE fast path), PyTorch.

Port of ``retto_tpu/pipeline/device_pipeline.py``.  Each image is uploaded
once at session resolution as uint8 (gray 1 B/px, YUV 4:2:0 1.5 B/px or
RGB 3 B/px); the det resize, the normalize, the three model forwards, the
det epilogue (mask and pooled prob map, the CUDA kernel of ``ops.db_pack``),
the crop warps and the CTC decode run on the device.  The host receives
the 1-bit det mask, a u8 prob map pooled to the det/4 grid, per-crop cls
probabilities and CTC indices/keep-masks/scores, and runs the sequential
tail: contours, min-area rects and unclip (``native`` ``rt_det_chunk``),
and string assembly.

Scheduling, as in the JAX pipeline but for the pack and the post pool: a
call is split into det chunks of ``BucketConfig.det_chunk`` images.  The
calling thread decodes and sizes each page and reads the pages' formats
(gray or YUV 4:2:0) a det chunk's worth at a time, in one native probe
threaded over them.  An upload thread packs each chunk's pages into its
stacked planes in one native call threaded over them (``_pack_chunk``;
page by page where the library cannot: the ``rgb`` transfer, odd extents,
no library), copies them to the card through pinned host buffers without
blocking and dispatches its det forward; the copies of the det maps to the
host are enqueued right behind it and completed on one of two fetch
threads, which then hands each image of the chunk to the post pool
(``_host_threads`` threads): contours, scoring and finalize in one
GIL-released C++ call an image, as soon as the maps land.  Meanwhile the
calling thread takes each chunk's boxes in chunk order, makes its crop
tasks and dispatches cls + rec.  The det forward
(per chunk key) and each fused cls + rec bucket run as one captured CUDA
graph each (``pipeline.graphs``, the counterpart of ``_build_jits``;
``compile_count`` counts them).  Crops accumulate across chunks and, in
``stream``, across batches, keyed by channel count: chunks of other upload
shapes meet in a device edge pad + concat (``_pad_concat``).

Spans (``utils.timing.StageTimers``, one per call; ``retto.<name> sid=...``
ranges on a profiler's timeline).  The calling thread's follow each other
and together cover the call: ``decode`` (and inside it ``gray_probe``,
the format probe, once a det chunk of pages), then per chunk
``upload_wait``, ``mask_fetch``, ``contours_wait`` (the wait for the chunk's boxes) and
``score``, per accumulator flush ``lock_wait``, ``flush`` (pad + concat,
the crops' buckets) and one ``clsrec_dispatch`` a bucket, then
``clsrec_wait`` and ``texts`` per handle and ``assemble``.  The upload
thread's ``upload`` (twice a chunk: the planes, with the chunk's ``pack``
inside it, then the dispatch under the lock, its wait excluded)
and ``lock_wait``, a fetch thread's ``fetch``
and a post-pool thread's ``contours`` (one an image) come back with their
results and the calling thread merges them.  On a card, a pair of
CUDA timing events around each det and cls + rec replay gives
``det_device`` and ``clsrec_device``, read once the copies recorded behind
them have completed.  ``last_stats`` is the call's counters beside
``t_<span>`` seconds and ``n_<span>`` counts; ``t_clsrec_fetch`` is
``t_clsrec_wait + t_texts``, and ``pages_packed_native`` counts the
pages the chunk pack wrote.

The det model is the port's ``DetModel`` (NHWC in its compute dtype,
stride-2 logits, pool 2) or any other module with the engine contract, an
``OnnxEngine`` graph among them: it takes NCHW float32 after the resize
and normalize in float32 and returns a full-resolution probability map,
which the det epilogue thresholds at ``det.thresh`` and pools by 4
(device_pipeline.py:340-355, 446-464, 489-495).

Data parallelism (``mesh=``, a ``parallel.mesh.Mesh`` that this process
drives), as in the JAX pipeline (device_pipeline.py:250-273, 470-481,
779-836): det and crop batch buckets round up to multiples of the mesh's
'data' size; each det chunk's rows split over the 'data' devices, and the
det forward and the det epilogue kernel run once per shard, on that
shard's device (the ``shard_map`` of the JAX kernel); each shard's image
tensor is then gathered whole onto every 'data' device, so a crop warp can
index any image of the chunk; each cls + rec bucket splits over 'data'
the same way; the maps and the results come back to the host per shard
and join in row order.  Every distinct device holds a replica of the three
models, its own graph caches (a graph replays only on the card that
captured it) and its own pinned staging.  Shards on one device share that
device's graphs: each replay's outputs are copied (image tensor) or sent
to the host right behind it on the device's stream, before the next
replay overwrites them.  The 'model' axis replicates, as in JAX.  A mesh
may name a device twice: on one card, ``[cuda:0, cuda:0]`` runs two shards
per chunk on that card.

Differences from the JAX pipeline, all of them scheduling: every dispatch
(det, cls + rec, the crop concat) and every capture runs under one lock,
on the current stream of the device it runs on, so the upload thread and
the calling thread take turns where XLA dispatches from both at once; the
uploads ride on that stream too, not on a stream of their own.  The lock
is the owning session's dispatch lock (``lock=``), which its staged
``TorchEngine`` holds around every forward too, its replicas' included.
The det postprocess runs an image a task on the post pool as each chunk's
maps land, where the JAX pipeline runs it a chunk a call on the calling
thread; each image's boxes are the same bytes either way.

Precision (stated here because a device changes it): contractions run in
the det model's compute dtype (bf16 for the shipped checkpoints); the BGR
normalize, YUV->RGB and the warp tails run in float32, and TF32 is off for
float32 matmuls and convolutions on CUDA, except inside the models' convs
that feed a BatchNorm (float32 sums of bf16 values, which TF32 computes
exactly; ``models.common``).  Each float32 conv sets cuDNN's
process-wide TF32 flag and launches under one process-wide lock
(``models.common.cudnn_tf32``), so sessions in other threads keep their
own setting.
"""

from __future__ import annotations

import logging
import math
import os
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np
import torch

from ..config import SessionConfig, rot180_label_perm
from ..errors import RettoError
from ..geometry import PointBox, scale_and_clip
from ..image.io import ImageHelper, decode_image, perspective_coeffs
from ..image.warp import _axis_matrix, blend_fill, warp_cols, warp_crops_multi, warp_rows
from ..image.yuv import rgb_to_yuv420, yuv420_to_rgb_device, yuv_planes_to_rgb
from ..models.dbnet import DetModel
from ..ops.charset import CharacterDict
from ..ops.ctc import ctc_greedy_decode
from ..ops.db_pack import db_epilogue, pooled_prob_plain, unpack_rows
from ..ops.db_post import binarize_dilate_packed, unpack_mask
from ..ops.det_postprocess import det_candidates, det_finalize
from ..results import (
    ClsLabel,
    ClsResult,
    DetBox,
    DetResult,
    OcrResult,
    RecResult,
    RecText,
    StageResult,
)
from ..utils.metrics import PipelineMetrics
from ..utils.timing import StageTimers
from ..parallel.mesh import mesh_devices, replicate_module
from .graphs import GraphCache, on_device
from .stages import _bucket_up, _next_bucket, det_input_dims

__all__ = ["DevicePipeline"]

logger = logging.getLogger("retto_tpu_torch.device_pipeline")


_INV255 = float(np.float32(1.0 / 255.0))

# host seconds in every call's last_stats, 0.0 where the span did not run
_STAGE_KEYS = ("t_decode", "t_upload_wait", "t_mask_fetch", "t_contours", "t_score",
               "t_clsrec_fetch")


def _host_threads(pages: int) -> int:
    """The width of host work spread over pages (the post pool: a det
    chunk's images; the native gray probe and chunk pack): a thread a page,
    within the CPUs this process may run on less three (the calling thread,
    the upload thread and a fetch thread)."""
    return min(pages, max(1, len(os.sched_getaffinity(0)) - 3))


def _is_gray(px: np.ndarray) -> bool:
    """R == G == B over an [h, w, 3] page: one native pass, else numpy."""
    from ..native import is_gray_native

    gray = is_gray_native(px)
    if gray is None:
        gray = bool((px[:, :, 0] == px[:, :, 1]).all() and (px[:, :, 1] == px[:, :, 2]).all())
    return gray


def _stack(pixels: Sequence[tuple[np.ndarray, ...]], nb: int) -> list[np.ndarray]:
    """Pages packed one by one (``_pack_one``) stacked into a chunk's planes,
    rows past the pages zero."""
    planes = []
    for p in range(len(pixels[0])):
        first = pixels[0][p]
        buf = np.zeros((nb, *first.shape), first.dtype)
        for k, px in enumerate(pixels):
            buf[k] = px[p]
        planes.append(buf)
    return planes


def _bilinear_matrix(
    src_valid: torch.Tensor, dst_valid: torch.Tensor, src_size: int, dst_size: int,
    replicate_out: bool = False,
) -> torch.Tensor:
    """Per-image bilinear resample matrix [B, dst_size, src_size] mapping
    [0, src_valid) onto [0, dst_valid) with PIL-style pixel centres; the
    triangle widens by the scale on downscales (PIL's anti-aliased
    BILINEAR).  Rows beyond dst_valid replicate the edge with
    ``replicate_out``, else are zero (device_pipeline.py:89-113)."""
    dev = src_valid.device
    i = torch.arange(dst_size, dtype=torch.float32, device=dev)[None, :, None]
    j = torch.arange(src_size, dtype=torch.float32, device=dev)[None, None, :]
    sv = src_valid[:, None, None]
    dv = dst_valid[:, None, None]
    scale = sv / dv
    support = torch.clamp(scale, min=1.0)
    sy = torch.minimum(torch.clamp((i + 0.5) * scale - 0.5, min=0.0), sv - 1.0)
    w = torch.clamp(1.0 - torch.abs(sy - j) / support, min=0.0)
    w = w * (j < sv) if replicate_out else w * (i < dv) * (j < sv)
    return w / torch.clamp(w.sum(dim=2, keepdim=True), min=1e-6)


def _resize2(wh: torch.Tensor, ww: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """img [B, H, W, C] -> [B, dh, dw, C] by two matmuls in the image's
    dtype, at least bf16 (device_pipeline.py:116-129)."""
    dt = torch.promote_types(img.dtype, torch.bfloat16)
    img = img.to(dt)
    t = torch.einsum("bdh,bhwc->bdwc", wh.to(dt), img)
    return torch.einsum("bew,bdwc->bdec", ww.to(dt), t)


def _is_aligned(quad, eps: float = 1e-3) -> bool:
    """True for an axis-aligned rectangle in normal orientation: eligible
    for the separable warp (device_pipeline.py:132-144)."""
    q = np.asarray(quad)
    return bool(
        abs(q[0, 1] - q[1, 1]) <= eps
        and abs(q[2, 1] - q[3, 1]) <= eps
        and abs(q[0, 0] - q[3, 0]) <= eps
        and abs(q[1, 0] - q[2, 0]) <= eps
        and q[1, 0] - q[0, 0] > eps
        and q[3, 1] - q[0, 1] > eps
    )


def _aligned_scal(quad, w_eff: float, h_eff: float, flip: bool) -> list[float]:
    """(ox, sx, oy, sy) mapping dest [0,w_eff)x[0,h_eff) onto the aligned
    quad (device_pipeline.py:147-157)."""
    q = np.asarray(quad, np.float64)
    x0, y0 = q[0]
    ws = q[1, 0] - q[0, 0]
    hs = q[3, 1] - q[0, 1]
    if flip:
        return [x0 + ws, -ws / w_eff, y0 + hs, -hs / h_eff]
    return [x0, ws / w_eff, y0, hs / h_eff]


@dataclass
class _CropTask:
    img_i: int
    box_i: int
    quad: np.ndarray  # warp-source quad in SESSION coords (maybe rot90'd)
    crop_h: int
    crop_w: int
    cls_label: Any = None
    im: Any = None  # owning _Img
    sid: int = 0  # owning _prepare state id (disambiguates img_i/box_i)


@dataclass
class _Img:
    ah: int  # session-resized size (resize_both)
    aw: int
    ori_h: int
    ori_w: int
    rh: int  # det input size (resize_either)
    rw: int
    hp: int = 0  # upload extents: (ah, aw) padded to upload_pad_to
    wp: int = 0
    fmt: str = "rgb"
    row: int = 0  # row within the chunk's stacked device tensor
    boxes: np.ndarray | None = None
    scores: np.ndarray | None = None
    crops: list[_CropTask] = field(default_factory=list)


@dataclass
class _Chunk:
    key: tuple  # (upload Hp, Wp, det dh, dw, plane format)
    idxs: list[int]
    # -> (fetch future, rgb, valids_src, bytes_up, pages packed natively, timers)
    upload_fut: Any = None
    rgb: Any = None  # the chunk's image tensor on each 'data' device
    valids_src: Any = None  # and its valid extents, likewise
    # set once the upload thread has read the pages' pixels into the planes
    packed: threading.Event = field(default_factory=threading.Event)


def _score_candidates(prob_small: np.ndarray, quads: np.ndarray) -> np.ndarray:
    """Mean probability inside each candidate quad on a 16x64 bilinear grid
    of the pooled u8 prob map (device_pipeline.py:197-238); the numpy
    fallback of ``rt_det_chunk``'s scoring."""
    if not len(quads):
        return np.zeros((0,), np.float32)
    q = np.asarray(quads, np.float32) / 4.0 - 0.375
    u = (np.arange(64, dtype=np.float32) + 0.5) / 64.0
    v = (np.arange(16, dtype=np.float32) + 0.5) / 16.0
    uu, vv = np.meshgrid(u, v)
    w00 = ((1 - uu) * (1 - vv))[None, ..., None]
    w10 = (uu * (1 - vv))[None, ..., None]
    w11 = (uu * vv)[None, ..., None]
    w01 = ((1 - uu) * vv)[None, ..., None]
    grid = (
        w00 * q[:, None, None, 0]
        + w10 * q[:, None, None, 1]
        + w11 * q[:, None, None, 2]
        + w01 * q[:, None, None, 3]
    )
    h, w = prob_small.shape
    x = np.clip(grid[..., 0], 0.0, w - 1.001)
    y = np.clip(grid[..., 1], 0.0, h - 1.001)
    x0 = np.floor(x).astype(np.int32)
    y0 = np.floor(y).astype(np.int32)
    fx = x - x0
    fy = y - y0
    p = prob_small.astype(np.float32)
    val = (
        p[y0, x0] * (1 - fx) * (1 - fy)
        + p[y0, x0 + 1] * fx * (1 - fy)
        + p[y0 + 1, x0] * (1 - fx) * fy
        + p[y0 + 1, x0 + 1] * fx * fy
    )
    return (val.mean(axis=(1, 2)) / 255.0).astype(np.float32)


class _Staging:
    """Pinned host buffers for the uploads, by shape and dtype.  A buffer is
    handed out again only after the event recorded behind its last copy
    has completed, so a non-blocking copy never reads a buffer that the
    host is refilling."""

    def __init__(self) -> None:
        self._slots: dict[tuple, list[list]] = {}

    def put(self, arr: np.ndarray, device: torch.device) -> torch.Tensor:
        arr = np.ascontiguousarray(arr)
        slots = self._slots.setdefault((arr.shape, arr.dtype.str), [])
        slot = next((s for s in slots if s[1].query()), None)
        if slot is None:
            slot = [torch.from_numpy(np.empty_like(arr)).pin_memory(), None]
            slots.append(slot)
        slot[0].numpy()[...] = arr
        out = slot[0].to(device, non_blocking=True)
        # the copy runs on the target device's current stream: the event
        # goes behind it there, whichever device is current
        slot[1] = torch.cuda.Event()
        slot[1].record(torch.cuda.current_stream(device))
        return out


class _Replica:
    """What one 'data' device holds: the three models, the constants the
    forwards read, its graph caches and its pinned staging."""

    def __init__(self, device: torch.device, det: torch.nn.Module, cls: torch.nn.Module,
                 rec: torch.nn.Module, config: SessionConfig):
        self.device = device
        self.det, self.cls, self.rec = det, cls, rec
        self.cls_label = torch.tensor([int(v) for v in config.cls.label],
                                      dtype=torch.int32, device=device)
        self.cls_perm = (
            torch.tensor(rot180_label_perm(config.cls.label), device=device)
            if config.cls.symmetrize else None
        )
        # on the device once: a host-to-device copy cannot run inside a
        # CUDA-graph capture
        f32 = dict(dtype=torch.float32, device=device)
        self.det_norm = tuple(torch.tensor(v, **f32) for v in (
            config.det.mean, config.det.std, config.det.scale))
        self.det_graphs = GraphCache(device)
        self.clsrec_graphs = GraphCache(device)
        self.staging = _Staging() if device.type == "cuda" else None
        # (start, end) timing events, handed back once read (_host)
        self.marks: deque = deque()


def _pad_concat(th: int, tw: int, xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Edge-pad each [B, H, W, C] tensor to [B, th, tw, C] and concatenate
    (device_pipeline.py:303-316): chunks of different upload shapes share
    one crop accumulator.  Edge mode, so no synthetic content enters the
    warps' reach; the valid extents ride along unchanged."""
    outs = []
    for x in xs:
        h, w = x.shape[1], x.shape[2]
        if h != th or w != tw:
            rows = torch.clamp(torch.arange(th, device=x.device), max=h - 1)
            cols = torch.clamp(torch.arange(tw, device=x.device), max=w - 1)
            x = x.index_select(1, rows).index_select(2, cols)
        outs.append(x)
    return torch.cat(outs)


class DevicePipeline:
    """Fused det -> cls -> rec over ``run_many``/``run``/``run_stream``/
    ``stream``.  The models are ``nn.Module``s already on ``device`` in eval
    mode (``RettoSession`` builds them).  ``device`` defaults to ``"cuda"``
    (raises without a card); with ``mesh=`` the devices are the mesh's
    'data' devices and the models are on the first.  ``close()`` (or the
    context manager) shuts the host threads down."""

    def __init__(
        self,
        det_model: torch.nn.Module,
        cls_model: torch.nn.Module,
        rec_model: torch.nn.Module,
        config: SessionConfig,
        chars: CharacterDict,
        device: str | torch.device | None = None,
        metrics: PipelineMetrics | None = None,
        lock: threading.RLock | None = None,
        mesh=None,
    ):
        devices = mesh_devices(mesh, device)
        self.device = devices[0]
        if any(d.type == "cuda" for d in devices):
            # the float32 matmuls (normalize, gather-warp homographies, f32
            # presets) must not drop to TF32; the convs set cuDNN's flag
            # under models.common's lock
            torch.backends.cuda.matmul.allow_tf32 = False
        self.cfg = config
        self.chars = chars
        self.metrics = metrics if metrics is not None else PipelineMetrics()
        self.transfer = config.engine.transfer_format
        if self.transfer not in ("rgb", "yuv420"):
            raise ValueError(f"unknown transfer_format {self.transfer!r}")
        self.last_stats: dict[str, Any] = {}
        self._det_model = det_model
        self._cls_model = cls_model
        self._rec_model = rec_model
        # the port's DetModel takes NHWC in its compute dtype and returns
        # stride-s logits; any other det (an ONNX graph, OnnxEngine) keeps the
        # engine contract: NCHW float32 in, a full-resolution probability
        # map out (device_pipeline.py:340-355)
        self._det_native = isinstance(det_model, DetModel)
        self._det_stride = (int(getattr(det_model, "out_stride", 1) or 1)
                            if self._det_native else 1)
        self._det_dtype = ((getattr(det_model, "compute_dtype", None) or torch.float32)
                           if self._det_native else torch.float32)
        # one replica per distinct device; _shards[k] serves 'data' index k
        reps = {self.device: _Replica(self.device, det_model, cls_model, rec_model, config)}
        for d in devices:
            if d not in reps:
                reps[d] = _Replica(d, *(replicate_module(m, d) for m in
                                        (det_model, cls_model, rec_model)), config)
        self._replicas = list(reps.values())
        self._shards = [reps[d] for d in devices]
        self._data_size = len(devices)
        # the first device's caches (tests and chip_smoke.py read them)
        self._det_graphs = self._replicas[0].det_graphs
        self._clsrec_graphs = self._replicas[0].clsrec_graphs
        # every model dispatch and capture holds the session's dispatch lock
        # (see the module docstring); the upload thread streams chunks in
        # call order, the fetch threads wait for the det maps' copies
        self._lock = lock if lock is not None else threading.RLock()
        self._upload_pool = ThreadPoolExecutor(max_workers=1)
        self._fetch_pool = ThreadPoolExecutor(max_workers=2)
        self._post_pool = ThreadPoolExecutor(max_workers=_host_threads(config.buckets.det_chunk))
        self._sid = 0  # monotone _prepare state counter (stream keys)

    # ------------------------------------------------------------------ #
    def _det_fwd(self, planes, valid_src, valid_det, dh: int, dw: int, fmt: str,
                 rep: _Replica | None = None):
        """Device-side resize_either to the (dh, dw) det canvas, BGR
        normalize, det forward, fused binarize+dilate+bitpack, pooled prob
        map (device_pipeline.py:356-496), with ``rep``'s models (default the
        first device's).  ``planes`` by ``fmt``: "rgb" (u8 [B,Hp,Wp,3]),
        "yuv420" (y [B,Hp,Wp] + uv [B,Hp/2,Wp/2,2]) or "gray" (y
        [B,Hp,Wp]).  Also returns the session-resolution u8 image tensor the
        crop warps read (one channel for gray)."""
        rep = rep or self._shards[0]
        det_cfg = self.cfg.det
        det_dtype = self._det_dtype
        vs = valid_src.to(torch.float32)
        vd = valid_det.to(torch.float32)
        if fmt == "yuv420":
            y, uv = planes
            _, hp, wp = y.shape
            wh = _bilinear_matrix(vs[:, 0], vd[:, 0], hp, dh, replicate_out=True)
            ww = _bilinear_matrix(vs[:, 1], vd[:, 1], wp, dw, replicate_out=True)
            wh2 = _bilinear_matrix(vs[:, 0] / 2, vd[:, 0], hp // 2, dh, replicate_out=True)
            ww2 = _bilinear_matrix(vs[:, 1] / 2, vd[:, 1], wp // 2, dw, replicate_out=True)
            ydet = _resize2(wh, ww, y.to(det_dtype)[..., None])[..., 0]
            uvdet = _resize2(wh2, ww2, uv.to(det_dtype))
            rgb_det = yuv_planes_to_rgb(
                ydet.to(torch.float32),
                uvdet[..., 0].to(torch.float32),
                uvdet[..., 1].to(torch.float32),
            )
            rgb_full = yuv420_to_rgb_device(y, uv)
            rgb_u8 = torch.clamp(torch.round(rgb_full), 0, 255).to(torch.uint8)
        elif fmt == "gray":
            (y,) = planes
            _, hp, wp = y.shape
            wh = _bilinear_matrix(vs[:, 0], vd[:, 0], hp, dh, replicate_out=True)
            ww = _bilinear_matrix(vs[:, 1], vd[:, 1], wp, dw, replicate_out=True)
            ydet = _resize2(wh, ww, y.to(det_dtype)[..., None])
            rgb_det = ydet.expand(*ydet.shape[:-1], 3)
            rgb_u8 = y[..., None]  # crops stay single-channel
        else:
            (rgb,) = planes
            _, hp, wp, _ = rgb.shape
            wh = _bilinear_matrix(vs[:, 0], vd[:, 0], hp, dh, replicate_out=True)
            ww = _bilinear_matrix(vs[:, 1], vd[:, 1], wp, dw, replicate_out=True)
            rgb_det = _resize2(wh, ww, rgb.to(det_dtype))
            rgb_u8 = rgb
        x = rgb_det.flip(-1)  # BGR (det_processor.rs:268)
        # normalize in f32 and round to the compute dtype ONCE (the r4
        # post-mortem in PERF.md: per-op bf16 rounding shifts the background
        # code and the det model amplifies it).  The JAX reference contracts
        # x*scale - mean into a fused multiply-add (one rounding); the
        # product of f32 operands is exact in f64, so computing that step
        # in f64 and rounding to f32 reproduces it on any device.
        mean, std, scale = rep.det_norm
        x = (x.to(torch.float64) * scale.double() - mean.double()).to(torch.float32)
        x = (x / std).to(det_dtype)
        s = self._det_stride
        if self._det_native:
            pred = rep.det(x, nhwc=True, raw_logits=s > 1)
        else:  # f32 NCHW in, probabilities out (device_pipeline.py:446-454)
            pred = rep.det(x.permute(0, 3, 1, 2).contiguous())
        mh, mw = dh // s, dw // s
        dilate = det_cfg.use_dilation and det_cfg.dilation_kernel is not None
        pred_map = pred[:, 0]
        # the head returns logits when s > 1: p > t  <=>  logit > ln(t / (1 - t))
        logits = self._det_native and s > 1
        t = float(det_cfg.thresh)
        bin_thresh = float(math.log(t / (1.0 - t))) if logits else t
        # the mean-pooled u8 prob map on the det/4 grid rides down with the mask
        pf = max(4 // s, 1)
        if mh % 64 == 0 and mw % 128 == 0:
            # one pass (CUDA kernel on the card): row-packed mask
            # [B, mh/8, mw] and the pooled prob map
            packed, prob_small = db_epilogue(pred_map.contiguous(), bin_thresh, dilate,
                                             pf, logits)
        else:
            packed = torch.stack(
                [binarize_dilate_packed(p, bin_thresh, dilate) for p in pred_map]
            )
            prob_small = pooled_prob_plain(pred_map, pf, logits)
        return packed, prob_small, rgb_u8

    def _clsrec_fwd(
        self,
        imgs_u8: torch.Tensor,
        rows: torch.Tensor,
        cls_homogs: torch.Tensor,
        cls_flip_homogs: torch.Tensor,
        cls_widths: torch.Tensor,
        rec_homogs: torch.Tensor,
        rec_flip_homogs: torch.Tensor,
        rec_widths: torch.Tensor,
        valid_hw: torch.Tensor,
        out_w: int,
        use_cls: bool,
        rep: _Replica | None = None,
    ):
        """Fused cls + rec for one rec width bucket
        (device_pipeline.py:508-675), with ``rep``'s models (default the
        first device's).  The cls-driven 180-degree rotation
        selects the host-precomputed flipped sampling geometry on the
        device, so rec never waits on a cls round trip.  [N, 4] geometry
        (ox, sx, oy, sy) takes the separable warp with ONE shared vertical
        pass for the cls, rec and both flipped views; [N, 3, 3]
        homographies take the gather warp."""
        rep = rep or self._shards[0]
        cfg = self.cfg
        _, ch, cw = cfg.cls.image_shape
        _, rh, _ = cfg.rec.image_shape
        n = rows.shape[0]
        aligned = cls_homogs.dim() == 2
        bf16 = torch.bfloat16

        def to3(x):  # gray chunks warp single-channel crops
            return x if x.shape[1] == 3 else x.expand(x.shape[0], 3, *x.shape[2:])

        def norm_nchw(crops, widths):
            # resize_norm_image semantics (image_helper.rs:176-209),
            # (crops / 255 - 0.5) / 0.5 as XLA compiles it: one fused
            # multiply-add by float32(1/255), then times 2 (exact)
            x = (crops.double() * _INV255 - 0.5).float() * 2.0
            col = torch.arange(crops.shape[2], device=crops.device)[None, None, :, None]
            x = torch.where(col < widths[:, None, None, None], x, torch.zeros_like(x))
            return x.permute(0, 3, 1, 2)

        if aligned:
            h, w = imgs_u8.shape[1], imgs_u8.shape[2]
            src = imgs_u8[rows].to(bf16)  # [N, H, W, C]
            vh = valid_hw[rows, 0].to(torch.float32)
            vw = valid_hw[rows, 1].to(torch.float32)
            # one vertical pass on rh+1 rows serves all views: the flipped
            # view's row v samples p(rh - v), i.e. rows rh..1 reversed
            wv, mv = _axis_matrix(rec_homogs[:, 2], rec_homogs[:, 3], h, rh + 1, vh)
            t_ext = warp_rows(wv, src)
            t_up, m_up = t_ext[:, :rh], mv[:, :rh]
            t_fl, m_fl = t_ext[:, 1:rh + 1].flip(1), mv[:, 1:rh + 1].flip(1)
            if ch != rh:
                wvc, mvc = _axis_matrix(cls_homogs[:, 2], cls_homogs[:, 3], h, ch + 1, vh)
                tc_ext = warp_rows(wvc, src)
                tc_up, mc_up = tc_ext[:, :ch], mvc[:, :ch]
                tc_fl, mc_fl = tc_ext[:, 1:ch + 1].flip(1), mvc[:, 1:ch + 1].flip(1)
            else:
                tc_up, mc_up, tc_fl, mc_fl = t_up, m_up, t_fl, m_fl

            def wpass(t_, mv_, xscal, out_w_):
                wu, mu = _axis_matrix(xscal[:, 0], xscal[:, 1], w, out_w_, vw)
                return blend_fill(warp_cols(wu, t_), mv_, mu, 255.0)

            def warp_cls():
                return wpass(tc_up, mc_up, cls_homogs, cw)

            def warp_cls_flip():
                return wpass(tc_fl, mc_fl, cls_flip_homogs, cw)

            def warp_rec():
                return wpass(t_up, m_up, rec_homogs, out_w)

            def warp_rec_flip():
                return wpass(t_fl, m_fl, rec_flip_homogs, out_w)
        else:
            def gwarp(geo, out_h_, out_w_):
                return warp_crops_multi(imgs_u8, rows, geo, valid_hw, out_h_, out_w_,
                                        fill=255.0)

            def warp_cls():
                return gwarp(cls_homogs, ch, cw)

            def warp_cls_flip():
                return gwarp(cls_flip_homogs, ch, cw)

            def warp_rec():
                return gwarp(rec_homogs, rh, out_w)

        if use_cls:
            probs = rep.cls(to3(norm_nchw(warp_cls(), cls_widths)))
            if rep.cls_perm is not None:
                # orientation-symmetrized score (ClsConfig.symmetrize)
                probs2 = rep.cls(to3(norm_nchw(warp_cls_flip(), cls_widths)))
                probs = 0.5 * (probs + probs2[:, rep.cls_perm])
            idx = torch.argmax(probs, dim=-1)
            score = torch.amax(probs, dim=-1)
            flip = (rep.cls_label[idx] == 180) & (score >= cfg.cls.thresh)
            if aligned:
                xr_up = norm_nchw(warp_rec(), rec_widths)
                xr_fl = norm_nchw(warp_rec_flip(), rec_widths)
                sel = flip.reshape((-1,) + (1,) * (xr_up.dim() - 1))
                xr = to3(torch.where(sel, xr_fl, xr_up))
            else:
                # gather warps read the full source per crop: select the
                # geometry, warp once
                geo = torch.where(flip.reshape(-1, 1, 1), rec_flip_homogs, rec_homogs)
                xr = to3(norm_nchw(gwarp(geo, rh, out_w), rec_widths))
        else:
            probs = torch.zeros((n, rep.cls_label.shape[0]), dtype=torch.float32,
                                device=imgs_u8.device)
            flip = torch.zeros((n,), dtype=torch.bool, device=imgs_u8.device)
            xr = to3(norm_nchw(warp_rec(), rec_widths))
        rec_probs = rep.rec(xr)
        valid_t = None
        if cfg.rec.mask_pad_timesteps:
            t_steps = rec_probs.shape[1]
            valid_t = torch.clamp(
                torch.ceil(t_steps * rec_widths / out_w) + 1, max=t_steps
            ).to(torch.int32)
        idxs, keep, scores = ctc_greedy_decode(rec_probs, valid_t=valid_t)
        return probs, flip, idxs, keep, scores

    # ------------------------------------------------------------------ #
    def run(self, data: bytes | np.ndarray) -> OcrResult:
        res = self.run_many([data])[0]
        if isinstance(res, RettoError):
            raise res
        return res

    def close(self) -> None:
        """Shut down the host thread pools.  Idempotent; after close() the
        pipeline cannot run (device_pipeline.py:688-693)."""
        self._upload_pool.shutdown(wait=True)
        self._fetch_pool.shutdown(wait=True)
        self._post_pool.shutdown(wait=True)

    def __enter__(self) -> "DevicePipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def compile_count(self) -> int:
        """Captured graphs (on a CPU device: static-buffer entries) over the
        det forward and the cls + rec buckets; JAX's count of jit-cache
        entries (device_pipeline.py:1005-1018), over every device's caches.
        A timed region that adds to it captured inside the timing."""
        return sum(len(r.det_graphs) + len(r.clsrec_graphs) for r in self._replicas)

    def run_many(
        self,
        inputs: Sequence[bytes | np.ndarray],
        stage_callback=None,
    ) -> list[OcrResult | RettoError]:
        """Fused batch run.  A per-image decode failure fills that slot
        with the error object; the rest of the batch proceeds.

        ``stage_callback(i, StageResult)`` receives per-image stage events
        as they materialize (det when its chunk's postprocess lands, cls
        and rec at assembly), in det -> cls -> rec order per image
        (device_pipeline.py:843-857)."""
        return self._finish(self._prepare(inputs), stage_callback)

    def run_stream(self, data: bytes | np.ndarray, callback) -> OcrResult:
        """Single-image stage streaming over the fused path."""
        res = self.run_many([data], lambda _i, ev: callback(ev))[0]
        if isinstance(res, RettoError):
            raise res
        return res

    def stream(self, batches):
        """Sustained streaming (device_pipeline.py:866-899): a generator over
        batches of inputs, pipelined two deep.  Batch i+1's decode and
        uploads run on a prep thread while batch i's postprocess tail
        completes, and batch i's results are yielded only after batch i+1's
        det phase, so i's underfull rec buckets absorb i+1's first crops.
        Results arrive in order, one batch behind the det work.  The
        iterator is advanced only once the upload thread has read the
        previous batch's pixels, so it may refill the arrays it yielded."""
        prep_pool = ThreadPoolExecutor(max_workers=1)

        def prepare(batch):
            state = self._prepare(batch)
            for ch in state["chunks"]:
                ch.packed.wait()
            return state

        acc: dict[tuple, dict] = {}
        handles: list[tuple[list[tuple], Any]] = []
        texts: dict[tuple, RecText] = {}
        try:
            it = iter(batches)
            try:
                state = prepare(next(it))
            except StopIteration:
                return
            prev = None
            for nxt in it:
                fut = prep_pool.submit(prepare, nxt)
                self._finish_det(state, acc, handles)
                if prev is not None:
                    yield self._assemble(prev, acc, handles, texts)
                prev, state = state, fut.result()
            self._finish_det(state, acc, handles)
            if prev is not None:
                yield self._assemble(prev, acc, handles, texts)
            yield self._assemble(state, acc, handles, texts)
        finally:
            prep_pool.shutdown(wait=False)

    # ------------------------------------------------------------------ #
    def _decode_one(self, data: bytes | np.ndarray) -> tuple[_Img, tuple[np.ndarray, ...]]:
        """Decode + session resize + pad-to-bucket + gray/YUV pack of one
        page (device_pipeline.py:702-777)."""
        im, px = self._geometry(data)
        return im, self._pack_one(im, px)

    def _geometry(self, data: bytes | np.ndarray) -> tuple[_Img, np.ndarray]:
        """Decode + session resize, and the page's sizes (session, det
        input, upload extents); the RGB pixels come back unpacked."""
        cfg = self.cfg
        bk = cfg.buckets
        img = ImageHelper(decode_image(data))
        ori_h, ori_w = img.size()
        img.resize_both(cfg.max_side_len, cfg.min_side_len)
        ah, aw = img.size()
        rh, rw = det_input_dims(
            ah, aw, cfg.det.limit_type, cfg.det.limit_side_len, bk.det_max_side,
        )
        hp = _bucket_up(ah, bk.upload_pad_to, 1 << 30)
        wp = _bucket_up(aw, bk.upload_pad_to, 1 << 30)
        return _Img(ah, aw, ori_h, ori_w, rh, rw, hp, wp), img.img

    def _pack_one(self, im: _Img, px: np.ndarray) -> tuple[np.ndarray, ...]:
        """One page's padded upload planes, in the format its pixels allow
        (``im.fmt``: gray, yuv420 or rgb)."""
        hp, wp = im.hp, im.wp

        def pad(arr: np.ndarray) -> np.ndarray:
            # edge-replicate so 4:2:0 chroma never bleeds padding colors
            if hp == arr.shape[0] and wp == arr.shape[1]:
                return arr
            width = ((0, hp - arr.shape[0]), (0, wp - arr.shape[1]))
            if arr.ndim == 3:
                width += ((0, 0),)
            return np.pad(arr, width, mode="edge")

        if self.transfer == "yuv420":
            from ..native import pack_auto_native, pack_gray_native, pack_yuv420_native

            auto = pack_auto_native(px, hp, wp)
            if auto is not None:
                gray, y_plane, uv_plane = auto
                if gray:
                    im.fmt = "gray"
                    planes = (y_plane,)
                else:
                    im.fmt = "yuv420"
                    planes = (y_plane, uv_plane)
            else:  # no compiler, or odd extents: two-pass numpy/C fallback
                if _is_gray(px):
                    im.fmt = "gray"
                    plane = pack_gray_native(px, hp, wp)
                    if plane is None:
                        plane = pad(np.ascontiguousarray(px[:, :, 0]))
                    planes = (plane,)
                else:
                    im.fmt = "yuv420"
                    packed = pack_yuv420_native(px, hp, wp)
                    if packed is None:
                        packed = rgb_to_yuv420(pad(px))
                    planes = packed
        else:
            im.fmt = "rgb"
            planes = (pad(px),)
        return planes

    @staticmethod
    def _put(arr: np.ndarray, rep: _Replica) -> torch.Tensor:
        """Host array -> tensor on ``rep``'s device.  On CUDA through its
        pinned staging buffers, without blocking the host; the caller holds
        the lock."""
        if rep.staging is None:
            return torch.from_numpy(np.ascontiguousarray(arr)).to(rep.device)
        return rep.staging.put(arr, rep.device)

    def _batch_bucket(self, n: int, buckets: Sequence[int]) -> int:
        """The batch bucket of ``n`` rows, rounded up to a multiple of the
        'data' size (device_pipeline.py:786-790)."""
        ds = self._data_size
        return -(-_next_bucket(n, buckets) // ds) * ds

    @staticmethod
    def _to_host(tensors: Sequence[torch.Tensor], marks=None) -> tuple[list, Any, Any]:
        """Enqueue copies of ``tensors`` (all on one device) to the host
        right behind the work that wrote them, on that device's current
        stream (pinned buffers, an event behind the copies): the graphs'
        static outputs are overwritten by the key's next replay.  ``_host``
        completes them, and reads ``marks`` (``_run_graph``), recorded
        before the copies, once they have."""
        dev = tensors[0].device
        if dev.type != "cuda":
            return [t.clone() for t in tensors], None, marks
        hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
        for h, t in zip(hosts, tensors):
            h.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        return hosts, ev, marks

    @staticmethod
    def _host(pendings: list[tuple[list, Any, Any]], tm: StageTimers, wait: str,
              device: str, **ids) -> list[np.ndarray]:
        """Complete each shard's copies (``_to_host``) in the span ``wait``,
        add each shard's device time between its marks to ``device``, and
        join the shards in row order."""
        parts = []
        for hosts, ev, marks in pendings:
            with tm.time(wait, **ids):
                if ev is not None:
                    ev.synchronize()
            if marks is not None:
                start, end, pool = marks
                tm.add(device, start.elapsed_time(end) / 1e3)
                pool.append((start, end))
            parts.append([h.numpy() for h in hosts])
        if len(parts) == 1:
            return parts[0]
        return [np.concatenate(xs) for xs in zip(*parts)]

    @contextmanager
    def _locked(self, tm: StageTimers, **ids):
        """Hold the dispatch lock; the wait for it is the span
        ``lock_wait``."""
        with tm.time("lock_wait", **ids):
            self._lock.acquire()
        try:
            yield
        finally:
            self._lock.release()

    @staticmethod
    def _run_graph(rep: _Replica, cache: GraphCache, key, fn, *args):
        """``cache.run(key, fn, *args)`` and the timing marks around it:
        on a card, a pair of CUDA events from ``rep``'s pool when the key
        replays (a capture and its warm-up are never timed), else None.
        The caller holds the lock, on ``rep``'s device."""
        if rep.staging is None or key not in cache:
            return cache.run(key, fn, *args), None
        stream = torch.cuda.current_stream(rep.device)
        start, end = rep.marks.pop() if rep.marks else (
            torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        start.record(stream)
        out = cache.run(key, fn, *args)
        end.record(stream)
        return out, (start, end, rep.marks)

    def _pack_chunk(self, key: tuple, imgs: Sequence[_Img], srcs: Sequence[np.ndarray],
                    nb: int) -> tuple[list[np.ndarray], int]:
        """The chunk ``key``'s stacked planes from its pages' RGB pixels: a
        gray or yuv420 chunk in one native call threaded over the pages
        (``pack_chunk_native``), else (the ``rgb`` transfer, odd extents,
        no library) page by page (``_pack_one``); returns them and the
        pages the native call packed."""
        from ..native import pack_chunk_native

        hp, wp, _, _, fmt = key
        if fmt != "rgb":
            planes = pack_chunk_native(srcs, hp, wp, nb, fmt == "gray",
                                       _host_threads(len(srcs)))
            if planes is not None:
                return list(planes), len(srcs)
        return _stack([self._pack_one(im, px) for im, px in zip(imgs, srcs)], nb), 0

    @torch.inference_mode()
    def _upload_and_det(self, chunk: _Chunk, imgs: list[_Img], srcs: list[np.ndarray],
                        nb: int, sid: int, ci: int):
        """Runs on the upload thread: pack the pages' RGB pixels into the
        chunk's stacked planes (``_pack_chunk``, the span ``pack``); per
        'data' shard of the rows, upload, dispatch the det forward on the
        shard's device and enqueue its det maps' copies to the host; gather
        the image tensor whole onto every device; hand the copies'
        completion to a fetch thread (device_pipeline.py:791-840).
        Counters and this thread's spans (``upload``, ``pack``,
        ``lock_wait``) are returned, never added into the shared stats from
        this thread."""
        hp, wp, dh, dw, fmt = chunk.key
        tm = StageTimers()
        with tm.time("upload", sid=sid, chunk=ci):
            try:
                with tm.time("pack", sid=sid, chunk=ci):
                    planes_np, packed_native = self._pack_chunk(chunk.key, imgs, srcs, nb)
            finally:
                chunk.packed.set()
            valids_src = np.ones((nb, 2), np.int32)
            valids_det = np.ones((nb, 2), np.int32)
            for k, im in enumerate(imgs):
                valids_src[k] = (im.ah, im.aw)
                valids_det[k] = (im.rh, im.rw)
        per = nb // self._data_size
        pending, rgbs = [], []
        with self._locked(tm, sid=sid, chunk=ci), tm.time("upload", sid=sid, chunk=ci):
            for k, rep in enumerate(self._shards):
                rows = slice(k * per, (k + 1) * per)
                with on_device(rep.device):
                    planes = tuple(self._put(b[rows], rep) for b in planes_np)
                    vs = self._put(valids_src[rows], rep)
                    vd = self._put(valids_det[rows], rep)
                    key = (tuple(tuple(p.shape) for p in planes), dh, dw, fmt)
                    (packed, prob_small, rgb), marks = self._run_graph(
                        rep, rep.det_graphs, key,
                        lambda *t, rep=rep: self._det_fwd(t[:-2], t[-2], t[-1], dh, dw,
                                                          fmt, rep),
                        *planes, vs, vd)
                    # the graph's outputs belong to the next replay of this
                    # key (the next shard or chunk): the image tensor waits
                    # in the crop accumulator, so it is cloned
                    rgbs.append(rgb.clone())
                    pending.append(self._to_host((packed, prob_small), marks))
            # crop warps index any image of the chunk: every device gets the
            # whole image tensor and the valid extents (device_pipeline.py:825-828)
            rgb = {r.device: torch.cat([x.to(r.device) for x in rgbs]) if len(rgbs) > 1
                   else rgbs[0] for r in self._replicas}
            vs = {r.device: self._put(valids_src, r) for r in self._replicas}
        fetch_fut = self._fetch_pool.submit(self._fetch_det, pending, sid, ci, chunk.key, imgs)
        return (fetch_fut, rgb, vs, sum(int(b.nbytes) for b in planes_np), packed_native,
                tm)

    def _fetch_det(self, pending: list, sid: int, ci: int, key: tuple = (),
                   imgs: Sequence[_Img] = ()):
        """Runs on a fetch thread: complete a chunk's det maps (the span
        ``fetch``, and ``det_device`` on a card) and hand the postprocess
        of ``imgs``, the chunk's images in row order, to the post pool;
        returns the maps, the spans and the images' futures, unjoined."""
        tm = StageTimers()
        maps = self._host(pending, tm, "fetch", "det_device", sid=sid, chunk=ci)
        return maps, tm, self._post_chunk(self._post_pool, key, imgs, *maps, sid, ci)

    def _post_chunk(self, pool: ThreadPoolExecutor, key: tuple, imgs: Sequence[_Img],
                    packed_np: np.ndarray, prob_np: np.ndarray, sid: int,
                    ci: int) -> list[Future]:
        """Submit one ``_contours`` task an image of the chunk ``key`` to
        ``pool``, row k with ``imgs[k]``; each future gives that image's
        boxes, scores and span."""
        return [pool.submit(self._contours, key, im, packed_np[k:k + 1], prob_np[k:k + 1],
                            sid, ci, k) for k, im in enumerate(imgs)]

    def _prepare(self, inputs: Sequence[bytes | np.ndarray]) -> dict:
        """Decode and size every input and hand each (upload shape, det
        bucket, format) chunk to the upload thread the moment it fills
        (device_pipeline.py:901-970); the upload thread packs the pages'
        pixels (``_pack_chunk``).  Under the ``yuv420`` transfer a page's
        format (gray or yuv420) comes from one native probe threaded over
        the pages awaiting it (the span ``gray_probe``; page by page
        without the library), run each time they fill a det chunk and at
        the end, so that a call's first chunk does not wait for its last
        decode.  The chunks form in input order."""
        from ..native import gray_batch_native

        cfg = self.cfg
        sid = self._sid
        self._sid += 1
        stats = {
            "images": len(inputs), "crops": 0, "chunks": 0, "bytes_up": 0,
            "bytes_down": 0, "dispatches": 0, "pad_concats": 0, "pages_packed_native": 0,
        }
        tm = StageTimers()
        t0 = time.perf_counter()
        bk = cfg.buckets
        imgs: list[_Img | None] = []
        srcs: list[np.ndarray | None] = []  # RGB pixels, packed on the upload thread
        pending: dict[tuple, list[int]] = {}
        chunks: list[_Chunk] = []
        todo: list[int] = []  # pages awaiting the probe, in input order
        placed = 0  # every page before this one is in its chunk

        def flush(key: tuple, idxs: list[int]) -> None:
            ch = _Chunk(key, idxs)
            for k, i in enumerate(idxs):
                imgs[i].row = k
            nb = self._batch_bucket(len(idxs), bk.det_batch_buckets)
            self.metrics.record_batch("det_batch", len(idxs), nb)
            stats["dispatches"] += 1
            ch.upload_fut = self._upload_pool.submit(
                self._upload_and_det, ch, [imgs[i] for i in idxs], [srcs[i] for i in idxs],
                nb, sid, len(chunks))
            chunks.append(ch)

        def place() -> None:
            # the pages into their chunks, in input order, up to the first
            # page whose format the probe has not read yet
            nonlocal placed
            stop = todo[0] if todo else len(imgs)
            for i in range(placed, stop):
                im = imgs[i]
                if im is None:
                    continue
                dh = _bucket_up(im.rh, bk.det_pad_to, bk.det_max_side)
                dw = _bucket_up(im.rw, bk.det_pad_to, bk.det_max_side)
                key = (im.hp, im.wp, dh, dw, im.fmt)
                pending.setdefault(key, []).append(i)
                if len(pending[key]) >= bk.det_chunk:
                    flush(key, pending.pop(key))
            placed = stop

        def probe() -> None:
            if todo:
                pages = [srcs[i] for i in todo]
                with tm.time("gray_probe", sid=sid):
                    grays = gray_batch_native(pages, _host_threads(len(pages)))
                    if grays is None:  # no library
                        grays = [_is_gray(px) for px in pages]
                for i, gray in zip(todo, grays):
                    imgs[i].fmt = "gray" if gray else "yuv420"
                todo.clear()
            place()

        errors: dict[int, RettoError] = {}
        with tm.time("decode", sid=sid):
            for data in inputs:
                i = len(imgs)
                try:
                    im, px = self._geometry(data)
                except RettoError as e:
                    logger.warning("device_pipeline: image %d failed: %s", i, e)
                    errors[i] = e
                    imgs.append(None)
                    srcs.append(None)
                    continue
                imgs.append(im)
                srcs.append(px)
                if self.transfer == "yuv420":
                    todo.append(i)
                    if len(todo) >= bk.det_chunk:
                        probe()
                else:
                    place()
            probe()
            for key, idxs in pending.items():
                flush(key, idxs)
        stats["chunks"] = len(chunks)
        return {"imgs": imgs, "chunks": chunks, "stats": stats, "timers": tm, "t0": t0,
                "errors": errors, "sid": sid}

    def _finish(self, state: dict, stage_callback=None) -> list[OcrResult | RettoError]:
        """``run_many``'s composition of the two halves that ``stream``
        drives itself (device_pipeline.py:972-980)."""
        acc: dict[tuple, dict] = {}
        handles: list[tuple[list[tuple], Any]] = []
        self._finish_det(state, acc, handles, stage_callback)
        return self._assemble(state, acc, handles, {}, stage_callback)

    def _flush_acc(self, acc: dict, key: tuple, handles: list, tm: StageTimers,
                   sid: int) -> None:
        """Dispatch an accumulator's crops: under the lock, the span
        ``flush`` (the chunks' pad + concat, the crops' buckets), then one
        ``clsrec_dispatch`` a bucket.  ``tm`` is the running call's."""
        a = acc.pop(key, None)
        if not a or not a["crops"]:
            return
        with self._locked(tm, sid=sid):
            with tm.time("flush", sid=sid):
                if len(a["chunks"]) == 1:
                    rgb, vs = a["chunks"][0]
                else:
                    shapes = {tuple(c[0][self.device].shape[1:3]) for c in a["chunks"]}
                    th, tw = (max(x[i] for x in shapes) for i in (0, 1))
                    a["stats"]["pad_concats"] += len(shapes) > 1
                    rgb, vs = {}, {}
                    for r in self._replicas:  # on every device alike
                        with on_device(r.device):
                            xs = [c[0][r.device] for c in a["chunks"]]
                            rgb[r.device] = (_pad_concat(th, tw, xs) if len(shapes) > 1
                                             else torch.cat(xs))
                            vs[r.device] = torch.cat([c[1][r.device] for c in a["chunks"]])
                base_of, buckets = self._clsrec_buckets(a["crops"])
            for b, (bw, aligned, items) in enumerate(buckets):
                with tm.time("clsrec_dispatch", sid=sid, bucket=b):
                    handles.append((items, self._dispatch_clsrec(
                        rgb, vs, base_of, bw, aligned, items, a["stats"])))

    @torch.inference_mode()
    def _finish_det(self, state: dict, acc: dict, handles: list,
                    stage_callback=None) -> None:
        """Per chunk: wait for its upload, its det maps and its images'
        postprocess (run on the post pool), then its crop tasks.  Crops
        accumulate by channel count across chunks (and, in ``stream``,
        across batches: ``acc`` and ``handles`` are the caller's) and
        dispatch in buckets of up to 64 (device_pipeline.py:1020-1152)."""
        imgs: list[_Img] = state["imgs"]
        stats = state["stats"]
        tm: StageTimers = state["timers"]
        sid = state["sid"]
        for ci, ch in enumerate(state["chunks"]):
            with tm.time("upload_wait", sid=sid, chunk=ci):
                (fetch_fut, ch.rgb, ch.valids_src, bytes_up, packed_native,
                 up_tm) = ch.upload_fut.result()
            tm.merge(up_tm)
            stats["bytes_up"] += bytes_up
            stats["pages_packed_native"] += packed_native
            with tm.time("mask_fetch", sid=sid, chunk=ci):
                (packed_np, prob_np), fetch_tm, post_futs = fetch_fut.result()
            tm.merge(fetch_tm)
            stats["bytes_down"] += int(packed_np.nbytes) + int(prob_np.nbytes)
            with tm.time("contours_wait", sid=sid, chunk=ci):
                posts = [f.result() for f in post_futs]
            for i, (boxes, scores, post_tm) in zip(ch.idxs, posts):
                imgs[i].boxes, imgs[i].scores = boxes, scores
                tm.merge(post_tm)
            with tm.time("score", sid=sid, chunk=ci):
                for i in ch.idxs:
                    im = imgs[i]
                    for j, b in enumerate(im.boxes):
                        pb = PointBox(b)
                        w_crop = max(int(max(pb.width_brc(), pb.width_tlc())), 1)
                        h_crop = max(int(max(pb.height_brc(), pb.height_tlc())), 1)
                        quad = np.asarray(b, np.float32)
                        if h_crop / w_crop >= 1.5:
                            # rot90-CCW crop == corners [tr, br, bl, tl]
                            # (image_helper.rs:245-247)
                            quad = quad[[1, 2, 3, 0]]
                            h_crop, w_crop = w_crop, h_crop
                        im.crops.append(_CropTask(i, j, quad, h_crop, w_crop, im=im, sid=sid))
                    stats["crops"] += len(im.boxes)
            if stage_callback is not None:
                for i in ch.idxs:
                    im = imgs[i]
                    b_ori = scale_and_clip(im.boxes, im.aw, im.ah, im.ori_w, im.ori_h)
                    stage_callback(i, StageResult(stage="det", result=DetResult(
                        [DetBox(PointBox(b), float(sc)) for b, sc in zip(b_ori, im.scores)])))
            chunk_crops = [c for i in ch.idxs for c in imgs[i].crops]
            if chunk_crops:
                # keyed by channel count only: chunks of other upload shapes
                # meet in the device pad + concat of _flush_acc; gray (1
                # channel) and color (3) cannot concat
                img = ch.rgb[self.device]
                key = (int(img.shape[-1]),)
                a = acc.setdefault(key, {"chunks": [], "crops": [], "rows": 0})
                a["stats"] = stats  # dispatches bill the flushing batch
                base = a["rows"]
                a["chunks"].append((ch.rgb, ch.valids_src))
                a["rows"] += int(img.shape[0])
                a["crops"].extend((c, base) for c in chunk_crops)
                if len(a["crops"]) >= 64:
                    self._flush_acc(acc, key, handles, tm, sid)

    def _contours(self, key: tuple, im: _Img, packed: np.ndarray, prob: np.ndarray,
                  sid: int, ci: int, row: int) -> tuple[np.ndarray, np.ndarray, StageTimers]:
        """One image's det postprocess, on a post-pool thread: contours,
        scoring and finalize in one C++ call (``rt_det_chunk`` over its
        row of the chunk ``key``'s maps), else numpy; returns its boxes,
        scores and span ``contours``."""
        cfg = self.cfg
        s = self._det_stride
        mh_full, mw_full = key[2] // s, key[3] // s
        row_packed = packed.shape[1] != mh_full  # kernel layout
        min_sside = max(1, cfg.det.min_mini_box_size // s)
        from ..native import det_chunk_native

        tm = StageTimers()
        with tm.time("contours", sid=sid, chunk=ci, row=row):
            outs = det_chunk_native(
                packed, row_packed, prob, [(im.rh // s, im.rw // s)], s,
                [(im.rh, im.rw)], [(im.ah, im.aw)],
                min_sside, cfg.det.max_candidates, cfg.det.box_thresh,
                cfg.det.unclip_ratio, cfg.det.min_mini_box_size,
            )
            if outs is not None:
                boxes, scores = outs[0]
            else:  # no compiler: numpy
                import dataclasses

                if row_packed:
                    mask = unpack_rows(packed[0], im.rh // s, im.rw // s)
                else:
                    mask = unpack_mask(packed[0], mw_full)[: im.rh // s, : im.rw // s]
                cands = det_candidates(
                    mask, dataclasses.replace(cfg.det, min_mini_box_size=min_sside))
                if s > 1 and len(cands):
                    cands = cands * float(s)
                boxes, scores = det_finalize(
                    cands, _score_candidates(prob[0], cands), cfg.det, im.rh, im.rw,
                    im.ah, im.aw)
        return boxes, scores, tm

    def _fetch_texts(self, handles: list, stats: dict, texts: dict, tm: StageTimers,
                     sid: int) -> None:
        """Complete the host copies of every handle's cls + rec outputs (the
        spans ``clsrec_wait``, and ``clsrec_device`` on a card) and decode
        texts into ``texts`` keyed (sid, img_i, box_i) (the spans
        ``texts``): handles may hold crops of several stream batches
        (device_pipeline.py:1154-1226)."""
        taken = list(handles)
        handles.clear()
        for entries, pending in taken:
            outs = self._host(pending, tm, "clsrec_wait", "clsrec_device", sid=sid)
            with tm.time("texts", sid=sid):
                self._texts(entries, outs, stats, texts)

    def _texts(self, entries: list, outs: list[np.ndarray], stats: dict,
               texts: dict) -> None:
        """One handle's cls labels and texts from its host outputs."""
        cfg = self.cfg
        probs, flip, idxs, keep, score = outs
        n = len(entries)
        probs, idxs, keep, score = probs[:n], idxs[:n], keep[:n], score[:n]
        stats["bytes_down"] += (
            probs.nbytes + flip.nbytes + idxs.nbytes + keep.nbytes + score.nbytes
        )
        pred = probs.argmax(axis=1) if n else np.zeros((0,), np.int64)
        by_crop: dict[tuple[int, int, int], list[tuple[int, tuple]]] = {}
        for r, e in enumerate(entries):
            c = e[0]
            by_crop.setdefault((c.sid, c.img_i, c.box_i), []).append((r, e))
        for key, seg_rows in by_crop.items():
            seg_rows.sort(key=lambda re: re[1][1])  # by seg index
            r0, (c, _s, k, _x0, natural, _w) = seg_rows[0]
            if cfg.use_cls:
                ki = int(pred[r0])
                c.cls_label = ClsLabel(
                    label=int(cfg.cls.label[ki]), score=float(probs[r0, ki])
                )
            if k == 1:
                text = self.chars.decode_indices(
                    idxs[r0 : r0 + 1], keep[r0 : r0 + 1]
                )[0]
                texts[key] = RecText(text=text, score=float(score[r0]))
                continue
            # chunked wide line: keep each timestep whose content-x
            # centre (x0 + 8t + 4) lies in the segment's half-overlap
            # window, then decode the concatenation
            bw = idxs.shape[1] * 8
            step = (natural - bw) / (k - 1)
            cat_idx, cat_keep, w_scores, w_counts = [], [], [], []
            tt = np.arange(idxs.shape[1], dtype=np.float64) * 8.0 + 4.0
            for r, (_cc, s, _k, x0, _nat, _w) in seg_rows:
                lo = -np.inf if s == 0 else x0 + (bw - step) / 2.0
                hi = np.inf if s == k - 1 else x0 + (bw + step) / 2.0
                win = ((x0 + tt) >= lo) & ((x0 + tt) < hi)
                kr = keep[r] & win
                cat_idx.append(idxs[r])
                cat_keep.append(kr)
                w_scores.append(float(score[r]))
                w_counts.append(int(kr.sum()))
            text = self.chars.decode_indices(
                np.concatenate(cat_idx)[None], np.concatenate(cat_keep)[None],
            )[0]
            tot = sum(w_counts)
            sc = (
                sum(s_ * c_ for s_, c_ in zip(w_scores, w_counts)) / tot
                if tot else 0.0
            )
            texts[key] = RecText(text=text, score=float(sc))

    @torch.inference_mode()
    def _assemble(self, state: dict, acc: dict, handles: list, texts: dict,
                  stage_callback=None) -> list[OcrResult | RettoError]:
        """Flush the accumulators that still hold this state's crops (in
        ``stream`` they may also hold newer batches' crops: dispatching them
        together fills the buckets), fetch every handle, build the results
        (device_pipeline.py:1228-1285)."""
        cfg = self.cfg
        imgs: list[_Img] = state["imgs"]
        stats = state["stats"]
        tm: StageTimers = state["timers"]
        sid = state["sid"]
        for key in [k for k, a in acc.items() if any(c.sid <= sid for c, _ in a["crops"])]:
            self._flush_acc(acc, key, handles, tm, sid)
        if handles:
            self._fetch_texts(handles, stats, texts, tm, sid)
        errors: dict[int, RettoError] = state["errors"]
        out: list[OcrResult | RettoError] = []
        with tm.time("assemble", sid=sid):
            for i, im in enumerate(imgs):
                if im is None:
                    out.append(errors[i])
                    continue
                boxes_ori = scale_and_clip(im.boxes, im.aw, im.ah, im.ori_w, im.ori_h)
                det_res = DetResult(
                    [DetBox(PointBox(b), float(s)) for b, s in zip(boxes_ori, im.scores)]
                )
                cls_res = ClsResult(
                    [c.cls_label or ClsLabel() for c in im.crops] if cfg.use_cls else []
                )
                rec_res = RecResult([texts.pop((sid, i, c.box_i), RecText())
                                     for c in im.crops])
                if stage_callback is not None:
                    stage_callback(i, StageResult(stage="cls", result=cls_res))
                    stage_callback(i, StageResult(stage="rec", result=rec_res))
                out.append(OcrResult(det_res, cls_res, rec_res))
        last = {**dict.fromkeys(_STAGE_KEYS, 0.0), **stats, **tm.stats()}
        last["t_clsrec_fetch"] = last.get("t_clsrec_wait", 0.0) + last.get("t_texts", 0.0)
        last["t_total"] = time.perf_counter() - state["t0"]
        self.last_stats = last
        m = self.metrics
        m.images += stats["images"]
        m.crops += stats["crops"]
        m.pad_concats += stats["pad_concats"]
        m.pages_packed_native += stats["pages_packed_native"]
        m.record_latency(last["t_total"])
        for name, seconds in tm.totals.items():
            m.stage_time[name] += seconds
        m.stage_time["clsrec_fetch"] += last["t_clsrec_fetch"]
        return out

    # ------------------------------------------------------------------ #
    @staticmethod
    def _quad_homog(quad: np.ndarray, content_w: float, content_h: float,
                    rot180: bool = False) -> np.ndarray:
        rect = np.array(
            [[0, 0], [content_w, 0], [content_w, content_h], [0, content_h]],
            np.float64,
        )
        if rot180:
            rect = rect[[2, 3, 0, 1]]
        c = perspective_coeffs(rect, quad)
        return np.array(
            [[c[0], c[1], c[2]], [c[3], c[4], c[5]], [c[6], c[7], 1.0]], np.float32,
        )

    @staticmethod
    def _sub_quad(quad: np.ndarray, x0: float, x1: float, natural: float):
        """Sub-quad covering content columns [x0, x1) of [0, natural)."""
        a, b = x0 / natural, x1 / natural
        q = np.asarray(quad, np.float64)
        top_a = q[0] + a * (q[1] - q[0])
        top_b = q[0] + b * (q[1] - q[0])
        bot_a = q[3] + a * (q[2] - q[3])
        bot_b = q[3] + b * (q[2] - q[3])
        return np.stack([top_a, top_b, bot_b, bot_a])

    def _clsrec_buckets(self, crops: list[tuple[_CropTask, int]]) -> tuple[dict, list]:
        """The crops' dispatches: ({id(crop): its chunk's first row}, [(rec
        width bucket, aligned, entries)]), one per rec width bucket, warp
        kind and batch of at most the largest batch bucket.  Lines wider
        than the largest width bucket split into k uniformly spaced
        overlapping segments of the max width; the flipped reading of
        segment s samples the mirrored segment (device_pipeline.py:1317-1478).
        Entries are (crop, seg, k, x0, natural, rec_width)."""
        cfg = self.cfg
        bk = cfg.buckets
        _, rh, rw_default = cfg.rec.image_shape
        wmax = bk.rec_width_buckets[-1]
        base_of = {id(c): b for (c, b) in crops}
        by_width: dict[int, list[tuple]] = {}
        for c, _base in crops:
            natural = int(math.ceil(rh * c.crop_w / c.crop_h))
            if natural <= wmax:
                bw = _next_bucket(max(natural, rw_default), bk.rec_width_buckets)
                by_width.setdefault(bw, []).append(
                    (c, 0, 1, 0.0, float(natural), min(natural, bw))
                )
            else:
                ov = 2 * rh  # ~two glyph heights of overlap
                k = max(2, int(math.ceil((natural - ov) / (wmax - ov))))
                step = (natural - wmax) / (k - 1)
                for s in range(k):
                    by_width.setdefault(wmax, []).append(
                        (c, s, k, s * step, float(natural), wmax)
                    )
        bmax = bk.rec_batch_buckets[-1]
        buckets = []
        for bw, bucket_items in sorted(by_width.items()):
            split: dict[bool, list[tuple]] = {True: [], False: []}
            for e in bucket_items:
                split[_is_aligned(e[0].quad)].append(e)
            for aligned, all_items in split.items():
                for i0 in range(0, len(all_items), bmax):
                    buckets.append((bw, aligned, all_items[i0 : i0 + bmax]))
        return base_of, buckets

    def _dispatch_clsrec(self, rgb: dict, valids_src: dict, base_of: dict, bw: int,
                         aligned: bool, items: list, stats: dict) -> list:
        """One fused cls + rec dispatch (an entry of ``_clsrec_buckets``):
        its geometry, uploads and graph replay.  The rows split over the
        'data' shards; each shard runs as one captured graph on its device
        over that device's image tensor (``rgb`` and ``valids_src`` by
        device), keyed (image tensor shape, shard batch, width, use_cls,
        warp kind).  Returns the pending host copies per shard
        (``_to_host``).  The caller holds the lock."""
        cfg = self.cfg
        bk = cfg.buckets
        _, ch_h, cw = cfg.cls.image_shape
        _, rh, _ = cfg.rec.image_shape
        rows, rec_widths, cls_widths = [], [], []
        fwd_g, flip_g, cls_g, clsf_g = [], [], [], []
        for (c, s, k, x0, natural, w_eff) in items:
            rows.append(base_of[id(c)] + c.im.row)
            rec_widths.append(w_eff)
            cls_widths.append(min(cw, int(math.ceil(ch_h * c.crop_w / c.crop_h))))
            if k == 1:
                sub = sub_m = c.quad
            else:
                sub = self._sub_quad(c.quad, x0, x0 + bw, natural)
                sub_m = self._sub_quad(c.quad, natural - bw - x0,
                                       natural - x0, natural)
            seg_w = w_eff if k == 1 else bw
            if aligned:
                cls_g.append(_aligned_scal(c.quad, cls_widths[-1], ch_h, False))
                clsf_g.append(_aligned_scal(c.quad, cls_widths[-1], ch_h, True))
                fwd_g.append(_aligned_scal(sub, seg_w, rh, False))
                flip_g.append(_aligned_scal(sub_m, seg_w, rh, True))
            else:
                cls_g.append(self._quad_homog(c.quad, cls_widths[-1], ch_h))
                clsf_g.append(self._quad_homog(c.quad, cls_widths[-1], ch_h,
                                               rot180=True))
                fwd_g.append(self._quad_homog(sub, seg_w, rh))
                flip_g.append(self._quad_homog(sub_m, seg_w, rh, rot180=True))
        geos = [np.asarray(g, np.float32) for g in (cls_g, clsf_g, fwd_g, flip_g)]
        nb = self._batch_bucket(len(items), bk.rec_batch_buckets)
        if nb > len(items):
            pad = nb - len(items)
            if aligned:
                filler = np.tile(np.asarray([[0.0, 1.0, 0.0, 1.0]], np.float32),
                                 (pad, 1))
            else:
                filler = np.tile(np.eye(3, dtype=np.float32)[None], (pad, 1, 1))
            geos = [np.concatenate([g, filler]) for g in geos]
            rec_widths = rec_widths + [1] * pad
            cls_widths = cls_widths + [1] * pad
            rows = rows + [0] * pad
        self.metrics.record_batch("rec_batch", len(items), nb)
        self.metrics.record_batch(
            f"rec_width_{bw}", int(sum(rec_widths[: len(items)])),
            bw * len(items),
        )
        stats["dispatches"] += 1
        use_cls = bool(cfg.use_cls)
        host = [np.asarray(rows, np.int64), np.asarray(cls_widths, np.int32),
                np.asarray(rec_widths, np.int32), *geos]
        per = nb // self._data_size
        pending = []
        for k, rep in enumerate(self._shards):
            part = slice(k * per, (k + 1) * per)
            with on_device(rep.device):
                rows_t, cls_w, rec_w, cls_geo, cls_flips, rec_geo, rec_flips = (
                    self._put(h[part], rep) for h in host)
                img = rgb[rep.device]
                out, marks = self._run_graph(
                    rep, rep.clsrec_graphs, (tuple(img.shape), per, bw, use_cls, aligned),
                    lambda *t, bw=bw, use_cls=use_cls, rep=rep: self._clsrec_fwd(
                        *t, out_w=bw, use_cls=use_cls, rep=rep),
                    img, rows_t, cls_geo, cls_flips, cls_w, rec_geo, rec_flips,
                    rec_w, valids_src[rep.device],
                )
                # the graph's outputs belong to the next replay of this key
                pending.append(self._to_host(out, marks))
        return pending
