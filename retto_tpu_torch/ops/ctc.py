"""CTC greedy decode on the device (PyTorch).

Port of ``retto_tpu/ops/ctc.py:25-61``: per row, argmax over classes (ties
resolve to the FIRST index, as ``jnp.argmax`` does), drop blanks (index 0),
collapse adjacent repeats, score = mean probability of the kept steps.
Only the small index/keep/score tensors leave the device.
"""

from __future__ import annotations

import torch

__all__ = ["ctc_greedy_decode"]


def ctc_greedy_decode(
    probs: torch.Tensor,
    remove_duplicate: bool = True,
    valid_t: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """probs [N, T, C] post-softmax -> (idx [N, T] int32, keep [N, T] bool,
    score [N] f32).  ``valid_t`` [N]: steps >= valid_t lie in the right
    zero-padding and are forced to blank (ctc.py:42-49)."""
    idx = torch.argmax(probs, dim=-1).to(torch.int32)
    prob = torch.amax(probs, dim=-1)
    keep = idx != 0
    if valid_t is not None:
        steps = torch.arange(idx.shape[1], dtype=torch.int32, device=idx.device)[None, :]
        keep = keep & (steps < valid_t.to(torch.int32)[:, None])
    if remove_duplicate:
        shifted = torch.cat([torch.full_like(idx[:, :1], -1), idx[:, :-1]], dim=1)
        keep = keep & (idx != shifted)
    cnt = keep.sum(dim=1)
    total = torch.where(keep, prob, torch.zeros_like(prob)).sum(dim=1)
    score = torch.where(cnt > 0, total / torch.clamp(cnt, min=1), torch.zeros_like(total))
    return idx, keep, score
