"""The three staged-pipeline stages (pre/post-processing around the engine).

Port of ``retto_tpu/pipeline/stages.py:64-270`` with its bucket helpers
(``_bucket_up`` :45, ``det_input_dims`` :49-61, ``_next_bucket`` :165).
Each stage is a callable taking host images and an Engine: the det
normalize, pad, threshold and dilation and the CTC decode run on the
engine's device; contours, the cls decision and string assembly run on the
host, as in the JAX stages.

Batching modes (config.PipelineMode):
* COMPAT — the reference's observable batching: descending-ratio sort,
  chunks of ``batch_num``, carried-over max_wh_ratio width
  (cls_processor.rs:137-170, rec_processor.rs:224-266).
* PERFORMANCE — width-bucketed dense batches with a small static shape set.
"""

from __future__ import annotations

import bisect
import math
from typing import Sequence

import numpy as np
import torch

from ..config import (
    BucketConfig,
    ClsConfig,
    DetConfig,
    PipelineMode,
    RecConfig,
    rot180_label_perm,
)
from ..image.io import ImageHelper, _pil_resize
from ..image.ops import normalize_det, pad_to
from ..image.resize import resize_either_dims
from ..ops.charset import CharacterDict
from ..ops.ctc import ctc_greedy_decode
from ..ops.db_post import binarize_dilate
from ..ops.det_postprocess import det_postprocess
from ..results import ClsLabel, RecText
from .engine import _host

__all__ = ["DetStage", "ClsStage", "RecStage", "det_input_dims"]


def _bucket_up(v: int, step: int, cap: int) -> int:
    return min(int(math.ceil(v / step)) * step, cap)


def det_input_dims(
    ah: int, aw: int, limit_type, limit_side_len: int, max_side: int
) -> tuple[int, int]:
    """resize_either dims clamped so both dims fit the det bucket cap
    (BucketConfig.det_max_side).  The clamp only triggers on extreme
    aspect-ratio upscales (e.g. a 640x200 input explodes to 2368 px wide
    under the reference's min-side-736 rule); the result stays /32."""
    rh, rw = resize_either_dims(ah, aw, limit_type, limit_side_len)
    if max(rh, rw) > max_side:
        scale = max_side / max(rh, rw)
        rh = max(int(rh * scale) // 32, 1) * 32
        rw = max(int(rw * scale) // 32, 1) * 32
    return rh, rw


def _next_bucket(v: int, buckets: Sequence[int]) -> int:
    pos = bisect.bisect_left(buckets, v)
    return buckets[pos] if pos < len(buckets) else buckets[-1] * (
        (v + buckets[-1] - 1) // buckets[-1]
    )


def _engine_device(engine) -> torch.device:
    return torch.device(getattr(engine, "device", "cpu"))


class DetStage:
    """PIL resize_either -> normalize (BGR) -> edge pad to the bucket ->
    engine.det -> slice -> binarize + dilate (device) -> contour postprocess
    (host) (stages.py:64-103; det_processor.rs:256-335)."""

    def __init__(self, cfg: DetConfig, buckets: BucketConfig):
        self.cfg = cfg
        self.buckets = buckets

    def __call__(self, image: ImageHelper, engine) -> tuple[np.ndarray, np.ndarray]:
        """Returns (boxes [N,4,2] float32 in ``image`` coords, scores [N])."""
        ah, aw = image.size()
        rh, rw = det_input_dims(
            ah, aw, self.cfg.limit_type, self.cfg.limit_side_len,
            self.buckets.det_max_side,
        )
        resized = image.img if (rh, rw) == (ah, aw) else _pil_resize(image.img, rw, rh)
        img = torch.tensor(resized, device=_engine_device(engine))  # PIL arrays are read-only
        x = normalize_det(img, self.cfg.mean, self.cfg.std, self.cfg.scale)
        bh = _bucket_up(rh, self.buckets.det_pad_to, self.buckets.det_max_side)
        bw = _bucket_up(rw, self.buckets.det_pad_to, self.buckets.det_max_side)
        # edge-replicate pad: a constant fill paints an image->pad edge the
        # det model fires on; the pred is sliced back to [:rh, :rw]
        x = pad_to(x, bh, bw, mode="edge")
        pred = torch.as_tensor(engine.det(x))[:, :, :rh, :rw]
        mask = binarize_dilate(
            pred, self.cfg.thresh,
            self.cfg.use_dilation and self.cfg.dilation_kernel is not None,
        )
        return det_postprocess(_host(pred[0, 0]), _host(mask), self.cfg, ah, aw)


class ClsStage:
    """Angle classification; rotates mis-oriented crops in place
    (stages.py:105-162; cls_processor.rs:127-171).  Batches, the rot180
    symmetrize and the decision stay on the host in numpy float32."""

    def __init__(self, cfg: ClsConfig, buckets: BucketConfig, mode: PipelineMode,
                 metrics=None):
        self.cfg = cfg
        self.buckets = buckets
        self.mode = mode
        self.metrics = metrics

    def __call__(self, crops: list[ImageHelper], engine) -> list[ClsLabel]:
        n = len(crops)
        if n == 0:
            return []
        labels: list[ClsLabel] = [ClsLabel() for _ in range(n)]
        order = sorted(range(n), key=lambda i: -crops[i].ori_ratio())
        shape = tuple(self.cfg.image_shape)

        if self.mode == PipelineMode.COMPAT:
            chunks = [
                order[i : i + self.cfg.batch_num]
                for i in range(0, n, self.cfg.batch_num)
            ]
        else:
            chunks = [order]  # single dense batch (cls shape is static)

        for chunk in chunks:
            batch = np.stack([crops[i].resize_norm_image(shape, None) for i in chunk])
            if self.mode == PipelineMode.PERFORMANCE:
                nb = _next_bucket(len(chunk), self.buckets.cls_batch_buckets)
                if self.metrics is not None:
                    self.metrics.record_batch("cls_batch", len(chunk), nb)
                if nb > len(chunk):
                    batch = np.concatenate(
                        [batch, np.zeros((nb - len(chunk), *batch.shape[1:]), np.float32)]
                    )
            probs = _host(engine.cls(batch))[: len(chunk)]
            # orientation-symmetrized score (ClsConfig.symmetrize):
            # p(label | crop) averaged with p(rot180(label) | rot180(crop))
            perm = rot180_label_perm(self.cfg.label) if self.cfg.symmetrize else None
            if perm is not None:
                flipped = np.ascontiguousarray(batch[:, :, ::-1, ::-1])
                probs2 = _host(engine.cls(flipped))[: len(chunk)]
                probs = 0.5 * (probs + probs2[:, list(perm)])
            pred = probs.argmax(axis=1)
            for row, i in enumerate(chunk):
                cls_idx = int(pred[row])
                score = float(probs[row, cls_idx])
                label = int(self.cfg.label[cls_idx])
                # rotate in place when 180 with confidence >= thresh
                # (cls_processor.rs:163-166)
                if label == 180 and score >= self.cfg.thresh:
                    crops[i].rotate_180_in_place()
                labels[i] = ClsLabel(label=label, score=score)
        return labels


class RecStage:
    """Text recognition with CTC decode on the device (stages.py:172-270;
    rec_processor.rs:214-270)."""

    def __init__(
        self,
        cfg: RecConfig,
        buckets: BucketConfig,
        mode: PipelineMode,
        chars: CharacterDict,
        metrics=None,
    ):
        self.cfg = cfg
        self.buckets = buckets
        self.mode = mode
        self.chars = chars
        self.metrics = metrics

    def __call__(self, crops: list[ImageHelper], engine) -> list[RecText]:
        n = len(crops)
        if n == 0:
            return []
        out: list[RecText] = [RecText() for _ in range(n)]
        _, img_h, img_w = self.cfg.image_shape
        order = sorted(range(n), key=lambda i: -crops[i].ori_ratio())

        if self.mode == PipelineMode.COMPAT:
            # carried-over max_wh_ratio across chunks (rec_processor.rs:
            # 237-247: the mutable accumulator never shrinks)
            max_wh_ratio = img_w / img_h
            for s in range(0, n, self.cfg.batch_num):
                chunk = order[s : s + self.cfg.batch_num]
                for i in chunk:
                    h, w = crops[i].size()
                    max_wh_ratio = max(max_wh_ratio, w / h)
                batch = np.stack(
                    [crops[i].resize_norm_image((3, img_h, img_w), max_wh_ratio)
                     for i in chunk]
                )
                self._run_decode(engine, batch, chunk, out)
        else:
            # width buckets: group crops by padded width (static shape set)
            groups: dict[int, list[int]] = {}
            for i in order:
                h, w = crops[i].size()
                natural = int(math.ceil(img_h * w / h))
                bw = _next_bucket(max(natural, img_w), self.buckets.rec_width_buckets)
                groups.setdefault(bw, []).append(i)
            for bw, idxs in sorted(groups.items()):
                batch = np.stack(
                    [crops[i].resize_norm_image((3, img_h, bw), None) for i in idxs]
                )
                nb = _next_bucket(len(idxs), self.buckets.rec_batch_buckets)
                if self.metrics is not None:
                    self.metrics.record_batch(f"rec_w{bw}", len(idxs), nb)
                if nb > len(idxs):
                    batch = np.concatenate(
                        [batch, np.zeros((nb - len(idxs), *batch.shape[1:]), np.float32)]
                    )
                widths = None
                if self.cfg.mask_pad_timesteps:
                    # content width on the bw-wide canvas, for pad-region
                    # CTC masking (RecConfig.mask_pad_timesteps)
                    widths = np.full((nb,), bw, np.int32)
                    for k, i in enumerate(idxs):
                        h, w = crops[i].size()
                        widths[k] = min(int(math.ceil(img_h * w / h)), bw)
                self._run_decode(engine, batch, idxs, out, widths, bw)
        return out

    def _run_decode(
        self,
        engine,
        batch: np.ndarray,
        idxs: Sequence[int],
        out: list[RecText],
        widths: np.ndarray | None = None,
        bucket_w: int | None = None,
    ) -> None:
        probs = torch.as_tensor(engine.rec(batch))
        valid_t = None
        if widths is not None:
            # timestep t covers pixels [t, t+1) * bucket_w / T; steps whose
            # window starts past the content edge (+1 step of slack for the
            # final glyph's receptive-field spill) are pad-only.  JAX runs
            # this with x64 off: the int32 product, then float32 division
            t_steps = probs.shape[1]
            w = torch.from_numpy(widths).to(probs.device) * t_steps
            f32 = dict(dtype=torch.float32, device=probs.device)
            steps = torch.ceil(w.to(torch.float32) / torch.tensor(float(bucket_w), **f32)) + 1.0
            valid_t = torch.clamp(steps, max=float(t_steps)).to(torch.int32)
        idx, keep, score = ctc_greedy_decode(probs, valid_t=valid_t)
        texts = self.chars.decode_indices(
            _host(idx)[: len(idxs)], _host(keep)[: len(idxs)]
        )
        scores = _host(score)
        for row, i in enumerate(idxs):
            out[i] = RecText(text=texts[row], score=float(scores[row]))
