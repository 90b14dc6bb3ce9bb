"""Accuracy from logits (the JAX package's ``ops/metrics.py``): argmax
is softmax-invariant, so this is the reference's accuracy over its
softmax outputs."""

from __future__ import annotations

import torch


def accuracy(logits: torch.Tensor, labels_onehot: torch.Tensor
             ) -> torch.Tensor:
    correct = torch.argmax(logits, dim=-1) == torch.argmax(labels_onehot,
                                                           dim=-1)
    return torch.mean(correct.to(torch.float32))
