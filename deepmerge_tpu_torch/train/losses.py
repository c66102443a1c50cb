"""Pair losses (port of ``deepmerge_tpu/train/losses.py``; reference
``Losses.py``).

The contrastive pair loss margins on the SQUARED distance
(``Losses.py:34-38``): ``loss = flag·d² + (1−flag)·relu(margin − d²)`` with
``flag=1`` meaning "same object". ``multi_loss`` adds the two CE class terms
(``Losses.py:41-69``); ``class_loss`` is the pure-CE variant (``:72-95``).
Every loss is computed in float32 whatever the embeddings' dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def contrastive_pair_loss(emb_left, emb_right, flag, margin: float = 1.0):
    """Mean contrastive pair loss over the batch.

    Args:
      emb_left, emb_right: (B, D) embeddings of the two regions of each pair.
      flag: (B,) 1.0 for same-object pairs, 0.0 for different-object.
      margin: squared-distance margin for negative pairs.
    """
    flag = flag.to(torch.float32)
    d2 = ((emb_left.to(torch.float32) - emb_right.to(torch.float32)) ** 2
          ).sum(dim=1)
    losses = flag * d2 + (1.0 - flag) * torch.relu(margin - d2)
    return losses.mean()


def _ce(logits, labels):
    """Mean softmax cross-entropy with integer labels, in float32."""
    return F.cross_entropy(logits.to(torch.float32), labels.long())


def class_loss(left_logits, left_labels, right_logits, right_labels):
    """0.5·CE(left) + 0.5·CE(right) (``Losses.py:89-95``)."""
    return 0.5 * _ce(left_logits, left_labels) + \
        0.5 * _ce(right_logits, right_labels)


def multi_loss(
    emb_left, emb_right, flag,
    left_logits, left_labels, right_logits, right_labels,
    margin: float = 1.0,
):
    """0.7·contrastive + 0.15·CE×2 (``Losses.py:58-69``)."""
    pair = contrastive_pair_loss(emb_left, emb_right, flag, margin)
    return 0.7 * pair + 0.15 * _ce(left_logits, left_labels) + \
        0.15 * _ce(right_logits, right_labels)


def triplet_loss(anchor, positive, negative, margin: float = 1.0,
                 lamda: float = 0.1, belta: float = 0.0):
    """Triplet variant (the reference's earlier, commented-out forward at
    ``Losses.py:20-32``): hinge on anchor-positive vs both negatives'
    squared distances plus a λ-weighted absolute pull term. (The reference's
    ``distance_negative_1`` accidentally sums over the whole batch — here it
    is the intended per-sample distance.)"""
    a = anchor.to(torch.float32)
    p = positive.to(torch.float32)
    n = negative.to(torch.float32)
    d_ap = ((a - p) ** 2).sum(dim=1)
    d_an = ((a - n) ** 2).sum(dim=1)
    d_pn = ((p - n) ** 2).sum(dim=1)
    l1 = torch.relu(d_ap - d_an + margin)
    l2 = torch.relu(d_ap - d_pn + margin)
    l3 = lamda * torch.relu(d_ap - belta)
    return (l1 + l2 + l3).mean()
