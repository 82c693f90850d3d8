"""Fused DB binarize + 2x2 dilate + 8x row bit-pack (the det epilogue).

Port of the TPU kernels ``retto_tpu/ops/pallas/db_pack.py``:
``binarize_dilate_pack_rows_batch`` (kernel ``_kernel_batched``, :144-169)
and ``binarize_dilate_pack_rows`` (``_kernel``, :116-141), which is the
B = 1 case here.  On a CUDA tensor the wrapper launches the hand-written
kernel ``csrc/db_pack.cu`` (built and loaded by ``kernels``); on a CPU
tensor it runs ``binarize_dilate_pack_rows_batch_plain``, the same
function in plain PyTorch.  There is no fallback from one to the other.

Layout: packing along ROWS keeps the full map width W as the fast axis;
row 8r of each group is the most significant bit (``numpy.unpackbits
(axis=0)``-compatible, read by ``rt_det_chunk(row_packed=1)``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "binarize_dilate_pack_rows",
    "binarize_dilate_pack_rows_batch",
    "binarize_dilate_pack_rows_batch_plain",
    "unpack_rows",
]

_TILE_H = 64  # the det bucket grid guarantees H % 64 == 0 and W % 128 == 0
_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def binarize_dilate_pack_rows_batch_plain(
    pred: torch.Tensor, thresh: float = 0.3, dilate: bool = True
) -> torch.Tensor:
    """[B, H, W] bf16/f32 -> u8 [B, H/8, W] in plain PyTorch: compare in
    f32, max over the up-left 2x2 window (zero pad above and left), weighted
    sum over groups of 8 rows."""
    b, h, w = pred.shape
    t = torch.tensor(thresh, dtype=torch.float32, device=pred.device)
    m = (pred.to(torch.float32) > t).to(torch.float32)
    if dilate:
        m = F.max_pool2d(F.pad(m[:, None], (1, 0, 1, 0)), 2, stride=1)[:, 0]
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32, device=pred.device)
    grouped = m.to(torch.int32).reshape(b, h // 8, 8, w)
    return (grouped * weights[:, None]).sum(dim=2).to(torch.uint8)


def _check(pred: torch.Tensor) -> None:
    if pred.dim() != 3:
        raise ValueError(f"expected [B, H, W], got shape {tuple(pred.shape)}")
    _, h, w = pred.shape
    if h % _TILE_H or w % 128:
        raise ValueError(f"H must be a multiple of 64 and W of 128, got {h}x{w}")
    if pred.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"expected bf16 or f32, got {pred.dtype}")


def binarize_dilate_pack_rows_batch(
    pred: torch.Tensor, thresh: float = 0.3, dilate: bool = True
) -> torch.Tensor:
    """[B, H, W] bf16/f32 (H % 64 == 0, W % 128 == 0) -> u8 [B, H/8, W].
    CUDA tensors launch ``csrc/db_pack.cu`` (counted in ``.launches``); CPU
    tensors take the plain version."""
    _check(pred)
    if pred.device.type == "cpu":
        return binarize_dilate_pack_rows_batch_plain(pred, thresh, dilate)
    if pred.device.type != "cuda":
        raise ValueError(f"unsupported device {pred.device}")
    if not pred.is_contiguous():
        raise ValueError("pred must be contiguous")
    from .. import kernels

    lib = kernels.load()
    b, h, w = pred.shape
    out = torch.empty((b, h // 8, w), dtype=torch.uint8, device=pred.device)
    with torch.cuda.device(pred.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rt_db_pack_rows(
            pred.data_ptr(), out.data_ptr(), b, h, w,
            int(pred.dtype == torch.bfloat16), float(thresh), int(bool(dilate)),
            stream,
        )
    kernels.check_launch(lib, err, "rt_db_pack_rows")
    binarize_dilate_pack_rows_batch.launches += 1
    return out


binarize_dilate_pack_rows_batch.launches = 0


def binarize_dilate_pack_rows(
    pred: torch.Tensor, thresh: float = 0.3, dilate: bool = True
) -> torch.Tensor:
    """One map [..., H, W] -> u8 [H/8, W]: the batched kernel at B = 1."""
    pred2d = pred.reshape(pred.shape[-2:])
    return binarize_dilate_pack_rows_batch(pred2d[None].contiguous(), thresh, dilate)[0]


def unpack_rows(packed: np.ndarray, h: int, w: int) -> np.ndarray:
    """Host-side inverse -> bool [h, w]."""
    return np.unpackbits(np.asarray(packed), axis=0)[:h, :w].astype(bool)
