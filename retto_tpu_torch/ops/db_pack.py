"""The DB det epilogue: binarize + 2x2 dilate + 8x row bit-pack of the det
map, and the mean-pooled u8 probability map, in one pass.

Port of the TPU kernels ``retto_tpu/ops/pallas/db_pack.py``:
``binarize_dilate_pack_rows_batch`` (kernel ``_kernel_batched``, :144-169)
and ``binarize_dilate_pack_rows`` (``_kernel``, :116-141), which is the
B = 1 case here, fused with the pooled prob map that the JAX pipeline
computes beside them (``retto_tpu/pipeline/device_pipeline.py:462``,
``:485-495``).  On a CUDA tensor the wrappers launch the hand-written kernel
``csrc/db_pack.cu`` (built and loaded by ``kernels``); on a CPU tensor they
run ``db_epilogue_plain``, the same function in plain PyTorch.  There is no
fallback from one to the other.

Layout: packing along ROWS keeps the full map width W as the fast axis;
row 8r of each group is the most significant bit (``numpy.unpackbits
(axis=0)``-compatible, read by ``rt_det_chunk(row_packed=1)``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels

__all__ = [
    "binarize_dilate_pack_rows",
    "binarize_dilate_pack_rows_batch",
    "binarize_dilate_pack_rows_batch_plain",
    "db_epilogue",
    "db_epilogue_plain",
    "pooled_prob_plain",
    "tile_edge_pixels",
    "unpack_rows",
    "KERNEL_TILE",
]

_TILE_H = 64  # the det bucket grid guarantees H % 64 == 0 and W % 128 == 0
_KERNEL_POOLS = (1, 2, 4)  # stride-4, stride-2 and stride-1 det maps
# rows x columns of the map that one block of csrc/db_pack.cu stages
KERNEL_TILE = (16, 128)
# (row, column) in a tile of one test pixel at each of its edges: the last
# row (the tile below reads it as its halo row), the last column (the tile
# to the right reads it as its left neighbour), the corner of the two, the
# first column (not image column 0 beyond the first tile), the first row,
# and the last row of the first packed group
_EDGE_OFFSETS = ((15, 60), (5, 127), (15, 127), (9, 0), (0, 90), (7, 30))


def binarize_dilate_pack_rows_batch_plain(
    pred: torch.Tensor, thresh: float = 0.3, dilate: bool = True
) -> torch.Tensor:
    """[B, H, W] bf16/f32 -> u8 [B, H/8, W] in plain PyTorch: compare in
    f32, max over the up-left 2x2 window (zero pad above and left), weighted
    sum over groups of 8 rows."""
    b, h, w = pred.shape
    m = (pred.to(torch.float32) > thresh).to(torch.float32)
    if dilate:
        m = F.max_pool2d(F.pad(m[:, None], (1, 0, 1, 0)), 2, stride=1)[:, 0]
    weights = 1 << torch.arange(7, -1, -1, dtype=torch.int32, device=pred.device)
    grouped = m.to(torch.int32).reshape(b, h // 8, 8, w)
    return (grouped * weights[:, None]).sum(dim=2).to(torch.uint8)


def pooled_prob_plain(pred: torch.Tensor, pool: int, logits: bool) -> torch.Tensor:
    """[B, H, W] -> u8 [B, H/pool, W/pool]: the mean over pool x pool
    windows of the probability map, times 255, rounded half to even and
    clamped.  With ``logits`` the map is a sigmoid of ``pred`` taken in
    XLA:CPU's steps for ``jax.nn.sigmoid``: ``1 / r(1 + r(exp(-x)))``, with
    ``r`` rounding to ``pred``'s dtype and the division in f32.  The window
    is summed row by row, left to right, as ``lax.reduce_window`` does, so
    the map equals the JAX pipeline's bit for bit."""
    x = pred.to(torch.float32)
    if logits:
        e = torch.exp(-x).to(pred.dtype).to(torch.float32)
        d = (1.0 + e).to(pred.dtype).to(torch.float32)
        x = torch.reciprocal(d)
    b, h, w = x.shape
    win = x.reshape(b, h // pool, pool, w // pool, pool)
    s = win[:, :, 0, :, 0]
    for i in range(pool):
        for j in range(pool):
            if i or j:
                s = s + win[:, :, i, :, j]
    return torch.clamp(torch.round(s * (255.0 / (pool * pool))), 0, 255).to(torch.uint8)


def db_epilogue_plain(
    pred: torch.Tensor, thresh: float = 0.3, dilate: bool = True, pool: int = 2,
    logits: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The det epilogue in plain PyTorch: (row-packed mask u8 [B, H/8, W],
    pooled prob map u8 [B, H/pool, W/pool])."""
    return (binarize_dilate_pack_rows_batch_plain(pred, thresh, dilate),
            pooled_prob_plain(pred, pool, logits))


def _check(pred: torch.Tensor, pool: int = 2) -> None:
    if pred.dim() != 3:
        raise ValueError(f"expected [B, H, W], got shape {tuple(pred.shape)}")
    _, h, w = pred.shape
    if h % _TILE_H or w % 128:
        raise ValueError(f"H must be a multiple of 64 and W of 128, got {h}x{w}")
    if pred.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"expected bf16 or f32, got {pred.dtype}")
    if pool not in _KERNEL_POOLS:
        raise ValueError(f"pool must be 1, 2 or 4, got {pool}")


def _launch(pred: torch.Tensor, thresh: float, dilate: bool, pool: int, logits: bool,
            with_prob: bool) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Allocate the outputs and launch ``rt_db_epilogue`` on the current
    stream; raises on a non-CUDA device or a launch error."""
    if pred.device.type != "cuda":
        raise ValueError(f"unsupported device {pred.device}")
    if not pred.is_contiguous() or pred.data_ptr() % 16:
        raise ValueError("pred must be contiguous and 16-byte aligned")
    lib = kernels.load()  # built on the first call, then the cached handle
    b, h, w = pred.shape
    dev = pred.device
    mask = torch.empty((b, h // 8, w), dtype=torch.uint8, device=dev)
    prob = (torch.empty((b, h // pool, w // pool), dtype=torch.uint8, device=dev)
            if with_prob else None)
    args = (pred.data_ptr(), mask.data_ptr(), prob.data_ptr() if with_prob else None,
            b, h, w, int(pred.dtype == torch.bfloat16), float(thresh), int(bool(dilate)),
            pool, int(bool(logits)))
    if dev.index is None or dev.index == torch.cuda.current_device():
        err = lib.rt_db_epilogue(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(dev):
            err = lib.rt_db_epilogue(*args, torch.cuda.current_stream().cuda_stream)
    kernels.check_launch(lib, err, "rt_db_epilogue")
    return mask, prob


def db_epilogue(
    pred: torch.Tensor, thresh: float = 0.3, dilate: bool = True, pool: int = 2,
    logits: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, H, W] bf16/f32 (H % 64 == 0, W % 128 == 0) -> (mask u8
    [B, H/8, W], prob u8 [B, H/pool, W/pool]), pool 1, 2 or 4.  CUDA tensors
    launch ``csrc/db_pack.cu`` once (counted in ``.launches``); CPU tensors
    take ``db_epilogue_plain``."""
    _check(pred, pool)
    if pred.device.type == "cpu":
        return db_epilogue_plain(pred, thresh, dilate, pool, logits)
    mask, prob = _launch(pred, thresh, dilate, pool, logits, with_prob=True)
    db_epilogue.launches += 1
    return mask, prob


db_epilogue.launches = 0


def binarize_dilate_pack_rows_batch(
    pred: torch.Tensor, thresh: float = 0.3, dilate: bool = True
) -> torch.Tensor:
    """[B, H, W] bf16/f32 (H % 64 == 0, W % 128 == 0) -> u8 [B, H/8, W]:
    the mask alone.  CUDA tensors launch the same kernel without its prob
    output (counted in ``.launches``); CPU tensors take the plain version."""
    _check(pred)
    if pred.device.type == "cpu":
        return binarize_dilate_pack_rows_batch_plain(pred, thresh, dilate)
    mask, _ = _launch(pred, thresh, dilate, 2, False, with_prob=False)
    binarize_dilate_pack_rows_batch.launches += 1
    return mask


binarize_dilate_pack_rows_batch.launches = 0
kernels.COUNTED.extend((db_epilogue, binarize_dilate_pack_rows_batch))


def binarize_dilate_pack_rows(
    pred: torch.Tensor, thresh: float = 0.3, dilate: bool = True
) -> torch.Tensor:
    """One map [..., H, W] -> u8 [H/8, W]: the batched kernel at B = 1."""
    pred2d = pred.reshape(pred.shape[-2:])
    return binarize_dilate_pack_rows_batch(pred2d[None].contiguous(), thresh, dilate)[0]


def tile_edge_pixels(shape: tuple[int, int, int]) -> tuple[np.ndarray, ...]:
    """(image, row, column) index arrays of one pixel at each edge of every
    ``KERNEL_TILE`` tile of a [B, H, W] map (``_EDGE_OFFSETS``).  No two
    lie within 2 pixels of each other, so each one's dilation shows alone."""
    b, h, w = shape
    th, tw = KERNEL_TILE
    bi, ty, tx, k = np.meshgrid(np.arange(b), np.arange(h // th), np.arange(w // tw),
                                np.arange(len(_EDGE_OFFSETS)), indexing="ij")
    off = np.asarray(_EDGE_OFFSETS)
    return bi.ravel(), (ty * th + off[k, 0]).ravel(), (tx * tw + off[k, 1]).ravel()


def unpack_rows(packed: np.ndarray, h: int, w: int) -> np.ndarray:
    """Host-side inverse -> bool [h, w]."""
    return np.unpackbits(np.asarray(packed), axis=0)[:h, :w].astype(bool)
