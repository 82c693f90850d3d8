"""Device-side image preprocessing (PyTorch).

Port of ``retto_tpu/image/ops.py:27-91``: the resize, normalize and pad
steps of the staged pipeline on tensors.  The public contract is NCHW
float32, as in the JAX module; images come in HWC.

Rounding: each function runs op by op, one rounding per op, as the JAX
functions do when called eagerly (the staged det calls ``normalize_det``
outside any jit, retto_tpu/pipeline/stages.py:86-88): ``x * scale``, then
``- mean``, then ``/ std``, with no fused multiply-add.  The fused
pipeline's normalize is the opposite case: inside a jit XLA fuses it into
one multiply-add (``pipeline.device_pipeline``).
"""

from __future__ import annotations

import torch

__all__ = ["resize_image", "normalize_det", "resize_norm_pad", "pad_to"]


def _triangle_weights(in_size: int, out_size: int, device) -> torch.Tensor:
    """[in_size, out_size] float32 weights of ``jax.image.resize(method=
    "linear", antialias=True)`` along one axis (jax/_src/image/scale.py
    ``compute_weight_mat``): a triangle kernel widened by 1/scale on a
    downscale, normalised per output, zero where the sample centre lies
    outside the input."""
    f32 = dict(dtype=torch.float32, device=device)
    inv_scale = torch.tensor(in_size / out_size, **f32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample = (torch.arange(out_size, **f32) + 0.5) * inv_scale - 0.5
    x = torch.abs(sample[None, :] - torch.arange(in_size, **f32)[:, None]) / kernel_scale
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_image(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Area-style resize of an HWC image: antialiased linear, the closest
    analog of the reference's box-filter ``thumbnail`` (image_helper.rs:
    128-133).  Output float32 [out_h, out_w, C] in [0, 255] (ops.py:27-34).
    The two axes are contracted as two float32 matmuls; the sums' order
    differs from XLA's, so values agree with ``jax.image.resize`` to float32
    rounding (tests/test_torch_image_ops.py states the tolerance)."""
    x = img.to(torch.float32)
    h, w = x.shape[0], x.shape[1]
    if (h, w) != (out_h, out_w):
        wh = _triangle_weights(h, out_h, x.device)
        ww = _triangle_weights(w, out_w, x.device)
        x = torch.einsum("hwc,ho->owc", x, wh)
        x = torch.einsum("owc,wp->opc", x, ww)
    return x


def normalize_det(
    img: torch.Tensor,
    mean: tuple[float, float, float] = (0.5, 0.5, 0.5),
    std: tuple[float, float, float] = (0.5, 0.5, 0.5),
    scale: float = 1.0 / 255.0,
    bgr: bool = True,
) -> torch.Tensor:
    """Det-stage normalize (det_processor.rs:152-163 + rgb2bgr at :268):
    ``(x * scale - mean) / std`` on an HWC image, optional BGR channel
    swap, returns NCHW [1, 3, H, W] float32 (ops.py:37-53).  The scalars
    are float32, as JAX's weakly typed constants are beside a float32
    array."""
    x = img.to(torch.float32)
    if bgr:
        x = x.flip(-1)
    f32 = dict(dtype=torch.float32, device=x.device)
    x = x * torch.tensor(scale, **f32)
    x = x - torch.tensor(mean, **f32)
    x = x / torch.tensor(std, **f32)
    return x.permute(2, 0, 1)[None].contiguous()


def resize_norm_pad(
    img: torch.Tensor, img_h: int, resized_w: int, target_w: int
) -> torch.Tensor:
    """Cls/rec crop normalize (image_helper.rs:176-209; ops.py:56-72):
    aspect resize to (img_h, resized_w), ``x/255 -> (v-0.5)/0.5``, CHW,
    zero-pad right to ``target_w``.  Output [3, img_h, target_w] float32."""
    x = resize_image(img, img_h, resized_w)
    x = (x / 255.0 - 0.5) / 0.5
    x = x.permute(2, 0, 1)
    return pad_to(x, img_h, target_w) if target_w > resized_w else x.contiguous()


def pad_to(
    x: torch.Tensor, h: int, w: int, value: float = 0.0, mode: str = "constant"
) -> torch.Tensor:
    """Pad the trailing two dims of ``x`` up to (h, w) (ops.py:75-91).
    ``mode="edge"`` replicates the border pixel: a constant fill paints a
    synthetic image->pad transition that a det model can fire on."""
    ph = h - x.shape[-2]
    pw = w - x.shape[-1]
    if ph < 0 or pw < 0:
        raise ValueError(f"pad_to: target ({h},{w}) smaller than {tuple(x.shape)}")
    if ph == 0 and pw == 0:
        return x
    if mode == "edge":
        rows = torch.clamp(torch.arange(h, device=x.device), max=x.shape[-2] - 1)
        cols = torch.clamp(torch.arange(w, device=x.device), max=x.shape[-1] - 1)
        return x.index_select(-2, rows).index_select(-1, cols)
    out = torch.full((*x.shape[:-2], h, w), value, dtype=x.dtype, device=x.device)
    out[..., : x.shape[-2], : x.shape[-1]] = x
    return out
