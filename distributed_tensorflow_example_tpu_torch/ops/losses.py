"""Cross-entropy losses over logits (the JAX package's ``ops/losses.py``).

``stable_cross_entropy`` (the default) is ``mean(-sum(y * log_softmax(z)))``
in log-sum-exp form.  ``naive_cross_entropy`` keeps the reference's own
arithmetic, ``log(softmax(z))``, which gives NaN once a softmax output
underflows to 0 (``--naive_ce``, for parity runs).
"""

from __future__ import annotations

import torch


def stable_cross_entropy(logits: torch.Tensor,
                         labels_onehot: torch.Tensor) -> torch.Tensor:
    log_probs = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.sum(labels_onehot * log_probs, dim=-1))


def naive_cross_entropy(logits: torch.Tensor,
                        labels_onehot: torch.Tensor) -> torch.Tensor:
    probs = torch.softmax(logits, dim=-1)
    return -torch.mean(torch.sum(labels_onehot * torch.log(probs), dim=-1))


def cross_entropy(logits: torch.Tensor, labels_onehot: torch.Tensor,
                  naive: bool = False,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """CE with optional label smoothing: the targets become
    ``y * (1 - eps) + eps / K``, for either arithmetic form."""
    if label_smoothing:
        k = labels_onehot.shape[-1]
        labels_onehot = (labels_onehot * (1.0 - label_smoothing)
                         + label_smoothing / k)
    if naive:
        return naive_cross_entropy(logits, labels_onehot)
    return stable_cross_entropy(logits, labels_onehot)
