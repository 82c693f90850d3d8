"""Training losses for the three model families (PyTorch).

Port of ``retto_tpu/train/losses.py:19-95``: CTC (rec), DB's balanced BCE
with hard-negative mining + masked L1 + dice (det, arXiv:1911.08947),
cross-entropy on the softmax output (cls).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["ctc_loss", "db_loss", "cls_loss"]


def ctc_loss(logits: torch.Tensor, labels: torch.Tensor,
             label_lengths: torch.Tensor) -> torch.Tensor:
    """Mean CTC loss.  logits [N, T, C] (pre-softmax, blank = class 0);
    labels [N, L] int padded with zeros; label_lengths [N].  As
    ``optax.ctc_loss(...).mean()``: the per-sequence negative log
    likelihood averaged over the batch (``F.ctc_loss(reduction="mean")``
    would also divide each by its target length)."""
    n, t, _ = logits.shape
    logp = F.log_softmax(logits.float(), dim=-1).transpose(0, 1)
    input_lengths = torch.full((n,), t, dtype=torch.long, device=logits.device)
    per_seq = F.ctc_loss(logp, labels.long(), input_lengths, label_lengths.long(),
                         blank=0, reduction="none", zero_infinity=False)
    return per_seq.mean()


def _dice(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
          eps: float = 1e-6) -> torch.Tensor:
    inter = (pred * gt * mask).sum()
    union = (pred * pred * mask).sum() + (gt * gt * mask).sum() + eps
    return 1.0 - 2.0 * inter / union


def db_loss(outputs: dict[str, torch.Tensor], gt_shrink: torch.Tensor,
            gt_shrink_mask: torch.Tensor, gt_thresh: torch.Tensor,
            gt_thresh_mask: torch.Tensor, alpha: float = 5.0, beta: float = 10.0,
            ohem_ratio: float = 3.0) -> torch.Tensor:
    """DB composite loss: balanced BCE on the prob map with online hard
    negative mining (every positive and the ``min(#neg, 3 #pos + 256)``
    largest negative losses, by a descending sort), L1 on the threshold map
    inside the border band, dice on the binary map.  ``outputs`` is the
    DetModel train dict, each [N, 1, H, W]; the targets [N, H, W] or
    [N, 1, H, W]."""

    def sq(x: torch.Tensor) -> torch.Tensor:
        return x.reshape(x.shape[0], *x.shape[-2:]).float()

    prob, thresh, binary = sq(outputs["maps"]), sq(outputs["thresh"]), sq(outputs["binary"])
    gt_s, m_s = sq(gt_shrink), sq(gt_shrink_mask)
    gt_t, m_t = sq(gt_thresh), sq(gt_thresh_mask)

    eps = 1e-6
    bce = -(gt_s * torch.log(prob + eps) + (1 - gt_s) * torch.log(1 - prob + eps))
    pos = gt_s * m_s
    neg = (1 - gt_s) * m_s
    n_pos = pos.sum()
    n_neg_keep = torch.minimum(neg.sum(), n_pos * ohem_ratio + 256)
    neg_losses = (bce * neg).reshape(-1)
    sorted_neg = torch.sort(neg_losses, descending=True).values
    rank = torch.arange(sorted_neg.numel(), dtype=torch.float32, device=prob.device)
    neg_loss = torch.where(rank < n_neg_keep, sorted_neg, torch.zeros_like(sorted_neg)).sum()
    pos_loss = (bce * pos).sum()
    bce_loss = (pos_loss + neg_loss) / (n_pos + n_neg_keep + eps)

    l1 = (torch.abs(thresh - gt_t) * m_t).sum() / (m_t.sum() + eps)
    dice = _dice(binary, gt_s, m_s)
    return bce_loss * alpha + l1 * beta + dice


def cls_loss(probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Cross entropy on the (post-softmax) cls output; labels [N] int."""
    logp = torch.log(probs.float() + 1e-8)
    return -logp.gather(1, labels.long()[:, None]).mean()
