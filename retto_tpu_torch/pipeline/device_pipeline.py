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

Scheduling, as in the JAX pipeline: a call is split into det chunks of
``BucketConfig.det_chunk`` images.  An upload thread stacks each chunk
into pinned host buffers, copies it to the card without blocking and
dispatches its det forward; the copies of the det maps to the host are
enqueued right behind it and completed on one of two fetch threads, while
the calling thread traces the contours of earlier chunks and dispatches
cls + rec.  The det forward (per chunk key) and each fused cls + rec
bucket run as one captured CUDA graph each (``pipeline.graphs``, the
counterpart of ``_build_jits``; ``compile_count`` counts them).  Crops
accumulate across chunks and, in ``stream``, across batches, keyed by
channel count: chunks of other upload shapes meet in a device edge pad +
concat (``_pad_concat``).

The det model is the port's ``DetModel`` (NHWC in its compute dtype,
stride-2 logits, pool 2) or any other module with the engine contract, an
``OnnxEngine`` graph among them: it takes NCHW float32 after the resize
and normalize in float32 and returns a full-resolution probability map,
which the det epilogue thresholds at ``det.thresh`` and pools by 4
(device_pipeline.py:340-355, 446-464, 489-495).

Differences from the JAX pipeline, all of them scheduling:

* every dispatch (det, cls + rec, the crop concat) and every capture runs
  under one lock on the device's current stream, so the upload thread
  and the calling thread take turns where XLA dispatches from both at
  once; the uploads ride on that stream too, not on a stream of their own.
  The lock is the owning session's dispatch lock (``lock=``), which its
  staged ``TorchEngine`` holds around every forward too;
* ``DevicePipeline(mesh=)`` (data parallelism over several cards) is not
  ported.

Precision (stated here because a device changes it): contractions run in
the det model's compute dtype (bf16 for the shipped checkpoints); the BGR
normalize, YUV->RGB and the warp tails run in float32, and TF32 is off for
float32 matmuls and convolutions on CUDA, except inside the models' convs
that feed a BatchNorm (float32 sums of bf16 values, which TF32 computes
exactly; ``models.common``).  The models flip cuDNN's process-wide TF32
flag around those convs, which is safe because every model call of the
session, fused or staged, runs under its one dispatch lock.
"""

from __future__ import annotations

import logging
import math
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np
import torch

from ..config import SessionConfig, rot180_label_perm
from ..device import resolve_device
from ..errors import RettoError
from ..geometry import PointBox, scale_and_clip
from ..image.io import ImageHelper, decode_image, perspective_coeffs
from ..image.warp import _axis_matrix, warp_crops_multi
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
from .graphs import GraphCache
from .stages import _bucket_up, _next_bucket, det_input_dims

__all__ = ["DevicePipeline"]

logger = logging.getLogger("retto_tpu_torch.device_pipeline")


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
    fmt: str = "rgb"
    row: int = 0  # row within the chunk's stacked device tensor
    boxes: np.ndarray | None = None
    scores: np.ndarray | None = None
    crops: list[_CropTask] = field(default_factory=list)


@dataclass
class _Chunk:
    key: tuple  # (upload Hp, Wp, det dh, dw, plane format)
    idxs: list[int]
    upload_fut: Any = None  # -> (fetch future, rgb, valids_src, bytes_up)
    rgb: Any = None
    valids_src: Any = None


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
        slot[1] = torch.cuda.Event()
        slot[1].record()
        return out


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
    mode (``RettoSession`` builds them).  ``close()`` (or the context
    manager) shuts the host threads down."""

    def __init__(
        self,
        det_model: torch.nn.Module,
        cls_model: torch.nn.Module,
        rec_model: torch.nn.Module,
        config: SessionConfig,
        chars: CharacterDict,
        device: str | torch.device = "cuda",
        metrics: PipelineMetrics | None = None,
        lock: threading.RLock | None = None,
    ):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # the float32 paths (normalize, gather-warp homographies, f32
            # presets) must not drop to TF32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
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
        self._cls_label = torch.tensor([int(v) for v in config.cls.label],
                                       dtype=torch.int32, device=self.device)
        self._cls_perm = (
            torch.tensor(rot180_label_perm(config.cls.label), device=self.device)
            if config.cls.symmetrize else None
        )
        # on the device once: a host-to-device copy cannot run inside a
        # CUDA-graph capture
        f32 = dict(dtype=torch.float32, device=self.device)
        self._det_norm = tuple(torch.tensor(v, **f32) for v in (
            config.det.mean, config.det.std, config.det.scale))
        # every model dispatch and capture holds the session's dispatch lock
        # (see the module docstring); the upload thread streams chunks in
        # call order, the fetch threads wait for the det maps' copies
        self._lock = lock if lock is not None else threading.RLock()
        self._det_graphs = GraphCache(self.device)
        self._clsrec_graphs = GraphCache(self.device)
        self._staging = _Staging() if self.device.type == "cuda" else None
        self._upload_pool = ThreadPoolExecutor(max_workers=1)
        self._fetch_pool = ThreadPoolExecutor(max_workers=2)
        self._sid = 0  # monotone _prepare state counter (stream keys)
        self.pad_concats = 0  # accumulator flushes that padded mixed shapes

    # ------------------------------------------------------------------ #
    def _det_fwd(self, planes, valid_src, valid_det, dh: int, dw: int, fmt: str):
        """Device-side resize_either to the (dh, dw) det canvas, BGR
        normalize, det forward, fused binarize+dilate+bitpack, pooled prob
        map (device_pipeline.py:356-496).  ``planes`` by ``fmt``: "rgb"
        (u8 [B,Hp,Wp,3]), "yuv420" (y [B,Hp,Wp] + uv [B,Hp/2,Wp/2,2]) or
        "gray" (y [B,Hp,Wp]).  Also returns the session-resolution u8 image
        tensor the crop warps read (one channel for gray)."""
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
        mean, std, scale = self._det_norm
        x = (x.to(torch.float64) * scale.double() - mean.double()).to(torch.float32)
        x = (x / std).to(det_dtype)
        s = self._det_stride
        if self._det_native:
            pred = self._det_model(x, nhwc=True, raw_logits=s > 1)
        else:  # f32 NCHW in, probabilities out (device_pipeline.py:446-454)
            pred = self._det_model(x.permute(0, 3, 1, 2).contiguous())
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
    ):
        """Fused cls + rec for one rec width bucket
        (device_pipeline.py:508-675).  The cls-driven 180-degree rotation
        selects the host-precomputed flipped sampling geometry on the
        device, so rec never waits on a cls round trip.  [N, 4] geometry
        (ox, sx, oy, sy) takes the separable warp with ONE shared vertical
        pass for the cls, rec and both flipped views; [N, 3, 3]
        homographies take the gather warp."""
        cfg = self.cfg
        _, ch, cw = cfg.cls.image_shape
        _, rh, _ = cfg.rec.image_shape
        n = rows.shape[0]
        aligned = cls_homogs.dim() == 2
        bf16 = torch.bfloat16

        def to3(x):  # gray chunks warp single-channel crops
            return x if x.shape[1] == 3 else x.expand(x.shape[0], 3, *x.shape[2:])

        def norm_nchw(crops, widths):
            # resize_norm_image semantics (image_helper.rs:176-209)
            x = (crops / 255.0 - 0.5) / 0.5
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
            t_ext = torch.einsum("ndh,nhwc->ndwc", wv.to(bf16), src)
            t_up, m_up = t_ext[:, :rh], mv[:, :rh]
            t_fl, m_fl = t_ext[:, 1:rh + 1].flip(1), mv[:, 1:rh + 1].flip(1)
            if ch != rh:
                wvc, mvc = _axis_matrix(cls_homogs[:, 2], cls_homogs[:, 3], h, ch + 1, vh)
                tc_ext = torch.einsum("ndh,nhwc->ndwc", wvc.to(bf16), src)
                tc_up, mc_up = tc_ext[:, :ch], mvc[:, :ch]
                tc_fl, mc_fl = tc_ext[:, 1:ch + 1].flip(1), mvc[:, 1:ch + 1].flip(1)
            else:
                tc_up, mc_up, tc_fl, mc_fl = t_up, m_up, t_fl, m_fl

            def wpass(t_, mv_, xscal, out_w_):
                wu, mu = _axis_matrix(xscal[:, 0], xscal[:, 1], w, out_w_, vw)
                out = torch.einsum("new,ndwc->ndec", wu.to(bf16), t_).to(torch.float32)
                mass = mv_[:, :, None] * mu[:, None, :]
                return out + (1.0 - mass)[..., None] * 255.0

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
            probs = self._cls_model(to3(norm_nchw(warp_cls(), cls_widths)))
            if self._cls_perm is not None:
                # orientation-symmetrized score (ClsConfig.symmetrize)
                probs2 = self._cls_model(to3(norm_nchw(warp_cls_flip(), cls_widths)))
                probs = 0.5 * (probs + probs2[:, self._cls_perm])
            idx = torch.argmax(probs, dim=-1)
            score = torch.amax(probs, dim=-1)
            flip = (self._cls_label[idx] == 180) & (score >= cfg.cls.thresh)
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
            probs = torch.zeros((n, self._cls_label.shape[0]), dtype=torch.float32,
                                device=imgs_u8.device)
            flip = torch.zeros((n,), dtype=torch.bool, device=imgs_u8.device)
            xr = to3(norm_nchw(warp_rec(), rec_widths))
        rec_probs = self._rec_model(xr)
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

    def __enter__(self) -> "DevicePipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def compile_count(self) -> int:
        """Captured graphs (on a CPU device: static-buffer entries) over the
        det forward and the cls + rec buckets; JAX's count of jit-cache
        entries (device_pipeline.py:1005-1018).  A timed region that adds
        to it captured inside the timing."""
        return len(self._det_graphs) + len(self._clsrec_graphs)

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
        Results arrive in order, one batch behind the det work."""
        prep_pool = ThreadPoolExecutor(max_workers=1)
        acc: dict[tuple, dict] = {}
        handles: list[tuple[list[tuple], Any]] = []
        texts: dict[tuple, RecText] = {}
        try:
            it = iter(batches)
            try:
                state = self._prepare(next(it))
            except StopIteration:
                return
            prev = None
            for nxt in it:
                fut = prep_pool.submit(self._prepare, nxt)
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
        """Decode + session resize + pad-to-bucket + gray/YUV pack
        (device_pipeline.py:702-777)."""
        cfg = self.cfg
        bk = cfg.buckets
        img = ImageHelper(decode_image(data))
        ori_h, ori_w = img.size()
        img.resize_both(cfg.max_side_len, cfg.min_side_len)
        ah, aw = img.size()
        rh, rw = det_input_dims(
            ah, aw, cfg.det.limit_type, cfg.det.limit_side_len, bk.det_max_side,
        )
        im = _Img(ah, aw, ori_h, ori_w, rh, rw)
        hp = _bucket_up(ah, bk.upload_pad_to, 1 << 30)
        wp = _bucket_up(aw, bk.upload_pad_to, 1 << 30)
        px = img.img

        def pad(arr: np.ndarray) -> np.ndarray:
            # edge-replicate so 4:2:0 chroma never bleeds padding colors
            if hp == arr.shape[0] and wp == arr.shape[1]:
                return arr
            width = ((0, hp - arr.shape[0]), (0, wp - arr.shape[1]))
            if arr.ndim == 3:
                width += ((0, 0),)
            return np.pad(arr, width, mode="edge")

        if self.transfer == "yuv420":
            from ..native import (
                is_gray_native,
                pack_auto_native,
                pack_gray_native,
                pack_yuv420_native,
            )

            auto = pack_auto_native(px, hp, wp)
            if auto is not None:
                gray, y_plane, uv_plane = auto
                if gray:
                    im.fmt = "gray"
                    planes = (y_plane,)
                else:
                    im.fmt = "yuv420"
                    planes = (y_plane, uv_plane)
            else:  # no compiler: two-pass numpy/C fallback
                gray = is_gray_native(px)
                if gray is None:
                    gray = bool(
                        (px[:, :, 0] == px[:, :, 1]).all()
                        and (px[:, :, 1] == px[:, :, 2]).all()
                    )
                if gray:
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
        return im, planes

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor.  On CUDA through a pinned staging
        buffer, without blocking the host; the caller holds the lock."""
        if self._staging is None:
            return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)
        return self._staging.put(arr, self.device)

    def _to_host(self, tensors: Sequence[torch.Tensor]) -> tuple[list, Any]:
        """Enqueue copies of ``tensors`` to the host right behind the work
        that wrote them (pinned buffers, an event behind the copies): the
        graphs' static outputs are overwritten by the key's next replay.
        ``_host`` completes them."""
        if self.device.type != "cuda":
            return [t.clone() for t in tensors], None
        hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
        for h, t in zip(hosts, tensors):
            h.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return hosts, ev

    @staticmethod
    def _host(pending: tuple[list, Any]) -> list[np.ndarray]:
        hosts, ev = pending
        if ev is not None:
            ev.synchronize()
        return [h.numpy() for h in hosts]

    @torch.inference_mode()
    def _upload_and_det(self, chunk: _Chunk, imgs: list[_Img],
                        pixels: list[tuple[np.ndarray, ...]], nb: int):
        """Runs on the upload thread: stack the pre-padded planes, upload,
        dispatch the det forward, enqueue the det maps' copies to the host
        and hand their completion to a fetch thread
        (device_pipeline.py:791-840).  Counters are returned, never added
        into the shared stats dict from this thread."""
        hp, wp, dh, dw, fmt = chunk.key
        planes_np = []
        for p in range(len(pixels[0])):
            first = pixels[0][p]
            buf = np.zeros((nb, *first.shape), first.dtype)
            for k, px in enumerate(pixels):
                buf[k] = px[p]
            planes_np.append(buf)
        valids_src = np.ones((nb, 2), np.int32)
        valids_det = np.ones((nb, 2), np.int32)
        for k, im in enumerate(imgs):
            valids_src[k] = (im.ah, im.aw)
            valids_det[k] = (im.rh, im.rw)
        with self._lock:
            planes = tuple(self._put(b) for b in planes_np)
            vs = self._put(valids_src)
            vd = self._put(valids_det)
            key = (tuple(tuple(p.shape) for p in planes), dh, dw, fmt)
            packed, prob_small, rgb = self._det_graphs.run(
                key, lambda *t: self._det_fwd(t[:-2], t[-2], t[-1], dh, dw, fmt),
                *planes, vs, vd)
            # the graph's outputs belong to the next chunk of this key: the
            # image tensor waits in the crop accumulator, so it is cloned
            rgb = rgb.clone()
            pending = self._to_host((packed, prob_small))
        fetch_fut = self._fetch_pool.submit(self._host, pending)
        return fetch_fut, rgb, vs, sum(int(b.nbytes) for b in planes_np)

    def _prepare(self, inputs: Sequence[bytes | np.ndarray]) -> dict:
        """Decode every input and hand each (upload shape, det bucket,
        format) chunk to the upload thread the moment it fills
        (device_pipeline.py:901-970)."""
        cfg = self.cfg
        sid = self._sid
        self._sid += 1
        stats = {
            "images": len(inputs), "crops": 0, "chunks": 0,
            "bytes_up": 0, "bytes_down": 0, "dispatches": 0,
            "t_decode": 0.0, "t_mask_fetch": 0.0, "t_contours": 0.0,
            "t_score": 0.0, "t_clsrec_fetch": 0.0, "t_total": 0.0,
            "t_upload_wait": 0.0,
        }
        t0 = time.perf_counter()
        bk = cfg.buckets
        imgs: list[_Img | None] = []
        pixels: list[tuple[np.ndarray, ...] | None] = []
        pending: dict[tuple, list[int]] = {}
        chunks: list[_Chunk] = []

        def flush(key: tuple, idxs: list[int]) -> None:
            ch = _Chunk(key, idxs)
            for k, i in enumerate(idxs):
                imgs[i].row = k
            nb = _next_bucket(len(idxs), bk.det_batch_buckets)
            self.metrics.record_batch("det_batch", len(idxs), nb)
            stats["dispatches"] += 1
            ch.upload_fut = self._upload_pool.submit(
                self._upload_and_det, ch, [imgs[i] for i in idxs],
                [pixels[i] for i in idxs], nb)
            chunks.append(ch)

        errors: dict[int, RettoError] = {}
        for data in inputs:
            i = len(imgs)
            try:
                im, planes = self._decode_one(data)
            except RettoError as e:
                logger.warning("device_pipeline: image %d failed: %s", i, e)
                errors[i] = e
                imgs.append(None)
                pixels.append(None)
                continue
            imgs.append(im)
            pixels.append(planes)
            hp = _bucket_up(im.ah, bk.upload_pad_to, 1 << 30)
            wp = _bucket_up(im.aw, bk.upload_pad_to, 1 << 30)
            dh = _bucket_up(im.rh, bk.det_pad_to, bk.det_max_side)
            dw = _bucket_up(im.rw, bk.det_pad_to, bk.det_max_side)
            key = (hp, wp, dh, dw, im.fmt)
            pending.setdefault(key, []).append(i)
            if len(pending[key]) >= bk.det_chunk:
                flush(key, pending.pop(key))
        for key, idxs in pending.items():
            flush(key, idxs)
        stats["chunks"] = len(chunks)
        stats["t_decode"] = time.perf_counter() - t0
        return {"imgs": imgs, "chunks": chunks, "stats": stats, "t0": t0,
                "errors": errors, "sid": sid}

    def _finish(self, state: dict, stage_callback=None) -> list[OcrResult | RettoError]:
        """``run_many``'s composition of the two halves that ``stream``
        drives itself (device_pipeline.py:972-980)."""
        acc: dict[tuple, dict] = {}
        handles: list[tuple[list[tuple], Any]] = []
        self._finish_det(state, acc, handles, stage_callback)
        return self._assemble(state, acc, handles, {}, stage_callback)

    def _flush_acc(self, acc: dict, key: tuple, handles: list) -> None:
        a = acc.pop(key, None)
        if not a or not a["crops"]:
            return
        with self._lock:
            if len(a["chunks"]) == 1:
                rgb, vs = a["chunks"][0]
            else:
                hs = {int(c[0].shape[1]) for c in a["chunks"]}
                ws = {int(c[0].shape[2]) for c in a["chunks"]}
                if len(hs) == 1 and len(ws) == 1:
                    rgb = torch.cat([c[0] for c in a["chunks"]])
                else:
                    rgb = _pad_concat(max(hs), max(ws), [c[0] for c in a["chunks"]])
                    self.pad_concats += 1
                vs = torch.cat([c[1] for c in a["chunks"]])
            handles.extend(self._dispatch_clsrec(rgb, vs, a["crops"], a["stats"]))

    @torch.inference_mode()
    def _finish_det(self, state: dict, acc: dict, handles: list,
                    stage_callback=None) -> None:
        """Per chunk: wait for its upload and its det maps, contours +
        scoring + finalize on the host in one C++ call, crop tasks.  Crops
        accumulate by channel count across chunks (and, in ``stream``,
        across batches: ``acc`` and ``handles`` are the caller's) and
        dispatch in buckets of up to 64 (device_pipeline.py:1020-1152)."""
        cfg = self.cfg
        imgs: list[_Img] = state["imgs"]
        stats = state["stats"]
        sid = state["sid"]
        s = self._det_stride
        for ch in state["chunks"]:
            t = time.perf_counter()
            fetch_fut, ch.rgb, ch.valids_src, bytes_up = ch.upload_fut.result()
            stats["t_upload_wait"] += time.perf_counter() - t
            stats["bytes_up"] += bytes_up
            t = time.perf_counter()
            packed_np, prob_np = fetch_fut.result()
            stats["t_mask_fetch"] += time.perf_counter() - t
            stats["bytes_down"] += int(packed_np.nbytes) + int(prob_np.nbytes)

            t = time.perf_counter()
            mh_full, mw_full = ch.key[2] // s, ch.key[3] // s
            row_packed = packed_np.shape[1] != mh_full  # kernel layout
            min_sside = max(1, cfg.det.min_mini_box_size // s)
            from ..native import det_chunk_native

            nb = len(ch.idxs)
            outs = det_chunk_native(
                packed_np[:nb], row_packed, prob_np[:nb],
                [(imgs[i].rh // s, imgs[i].rw // s) for i in ch.idxs], s,
                [(imgs[i].rh, imgs[i].rw) for i in ch.idxs],
                [(imgs[i].ah, imgs[i].aw) for i in ch.idxs],
                min_sside, cfg.det.max_candidates, cfg.det.box_thresh,
                cfg.det.unclip_ratio, cfg.det.min_mini_box_size,
            )
            if outs is not None:
                for i, (bx, sc) in zip(ch.idxs, outs):
                    imgs[i].boxes, imgs[i].scores = bx, sc
            else:  # no compiler: numpy fallback per image
                import dataclasses

                cfg_s = dataclasses.replace(cfg.det, min_mini_box_size=min_sside)
                for i in ch.idxs:
                    im = imgs[i]
                    if row_packed:
                        mask = unpack_rows(packed_np[im.row], im.rh // s, im.rw // s)
                    else:
                        mask = unpack_mask(packed_np[im.row], mw_full)[
                            : im.rh // s, : im.rw // s
                        ]
                    cands = det_candidates(mask, cfg_s)
                    if s > 1 and len(cands):
                        cands = cands * float(s)
                    scores_i = _score_candidates(prob_np[im.row], cands)
                    im.boxes, im.scores = det_finalize(
                        cands, scores_i, cfg.det, im.rh, im.rw, im.ah, im.aw
                    )
            stats["t_contours"] += time.perf_counter() - t

            t = time.perf_counter()
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
            stats["t_score"] += time.perf_counter() - t
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
                key = (int(ch.rgb.shape[-1]),)
                a = acc.setdefault(key, {"chunks": [], "crops": [], "rows": 0})
                a["stats"] = stats  # dispatches bill the flushing batch
                base = a["rows"]
                a["chunks"].append((ch.rgb, ch.valids_src))
                a["rows"] += int(ch.rgb.shape[0])
                a["crops"].extend((c, base) for c in chunk_crops)
                if len(a["crops"]) >= 64:
                    self._flush_acc(acc, key, handles)

    def _fetch_texts(self, handles: list, stats: dict, texts: dict) -> None:
        """Complete the host copies of every handle's cls + rec outputs and
        decode texts into ``texts`` keyed (sid, img_i, box_i): handles may
        hold crops of several stream batches (device_pipeline.py:1154-1226)."""
        cfg = self.cfg
        t = time.perf_counter()
        taken = list(handles)
        handles.clear()
        for entries, pending in taken:
            probs, flip, idxs, keep, score = self._host(pending)
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
        stats["t_clsrec_fetch"] += time.perf_counter() - t


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
        sid = state["sid"]
        for key in [k for k, a in acc.items() if any(c.sid <= sid for c, _ in a["crops"])]:
            self._flush_acc(acc, key, handles)
        if handles:
            self._fetch_texts(handles, stats, texts)
        errors: dict[int, RettoError] = state["errors"]
        out: list[OcrResult | RettoError] = []
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
            rec_res = RecResult([texts.pop((sid, i, c.box_i), RecText()) for c in im.crops])
            if stage_callback is not None:
                stage_callback(i, StageResult(stage="cls", result=cls_res))
                stage_callback(i, StageResult(stage="rec", result=rec_res))
            out.append(OcrResult(det_res, cls_res, rec_res))
        stats["t_total"] = time.perf_counter() - state["t0"]
        self.last_stats = stats
        m = self.metrics
        m.images += stats["images"]
        m.crops += stats["crops"]
        m.latencies_s.append(stats["t_total"])
        for k in ("t_decode", "t_mask_fetch", "t_contours", "t_score", "t_clsrec_fetch"):
            m.stage_time[k[2:]] += stats[k]
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

    def _dispatch_clsrec(self, rgb: torch.Tensor, valids_src: torch.Tensor,
                         crops: list[tuple[_CropTask, int]], stats: dict):
        """One fused cls+rec dispatch per rec width bucket (and per warp
        kind).  Lines wider than the largest bucket split into k uniformly
        spaced overlapping segments of the max width; the flipped reading
        of segment s samples the mirrored segment
        (device_pipeline.py:1317-1478).  Each bucket runs as one captured
        graph, keyed (image tensor shape, batch bucket, width, use_cls, warp
        kind).  Returns (entries, pending host copies) handles; entries are
        (crop, seg, k, x0, natural, rec_width).  The caller holds the lock."""
        cfg = self.cfg
        bk = cfg.buckets
        _, ch_h, cw = cfg.cls.image_shape
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
        handles = []
        bmax = bk.rec_batch_buckets[-1]
        for bw, bucket_items in sorted(by_width.items()):
            split: dict[bool, list[tuple]] = {True: [], False: []}
            for e in bucket_items:
                split[_is_aligned(e[0].quad)].append(e)
            for aligned, all_items in split.items():
                for i0 in range(0, len(all_items), bmax):
                    items = all_items[i0 : i0 + bmax]
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
                    nb = _next_bucket(len(items), bk.rec_batch_buckets)
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
                    cls_geo, cls_flips, rec_geo, rec_flips = (self._put(g) for g in geos)
                    use_cls = bool(cfg.use_cls)
                    out = self._clsrec_graphs.run(
                        (tuple(rgb.shape), nb, bw, use_cls, aligned),
                        lambda *t, bw=bw, use_cls=use_cls: self._clsrec_fwd(
                            *t, out_w=bw, use_cls=use_cls),
                        rgb,
                        self._put(np.asarray(rows, np.int64)),
                        cls_geo, cls_flips,
                        self._put(np.asarray(cls_widths, np.int32)),
                        rec_geo, rec_flips,
                        self._put(np.asarray(rec_widths, np.int32)),
                        valids_src,
                    )
                    # the graph's outputs belong to the next replay of this key
                    handles.append((items, self._to_host(out)))
        return handles
