"""Plain single-device attention (``[B, S, H, D]`` layout) and the
mask constant the decode path shares.  The sequence-parallel ring of
the JAX package's ``ops/ring_attention.py`` comes with the multi-GPU
slice (ROADMAP.md Queue A)."""

from __future__ import annotations

import math

import torch

# large-negative instead of -inf: keeps exp() NaN-free for rows that
# are fully masked
NEG_INF = -1e30


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``exp(x - max) / sum`` — the op order of ``jax.nn.softmax``
    (``torch.softmax`` multiplies by the reciprocal of the sum, which
    rounds differently)."""
    e = torch.exp(x - torch.amax(x, dim=dim, keepdim=True))
    return e / torch.sum(e, dim=dim, keepdim=True)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = False) -> torch.Tensor:
    """Softmax attention over [B, S, H, D] inputs.  The score product
    runs in the inputs' dtype and is cast to f32 after (bf16 rounding
    included), the mask is ``NEG_INF``, and the probabilities are
    cast to ``v.dtype`` before the value product — the JAX package's
    rounding points.  Under ``causal`` the q and k lengths must be
    equal."""
    # the scale is 1/sqrt(d) taken in double and rounded to f32 once,
    # as numpy's scalar is in the JAX version
    scale = torch.tensor(1.0 / math.sqrt(q.shape[-1]),
                         dtype=torch.float32)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) \
        * scale.to(q.device)
    if causal:
        sq, sk = scores.shape[-2], scores.shape[-1]
        if sq != sk:
            raise ValueError(
                f"causal attention requires equal q/k lengths, got "
                f"sq={sq}, sk={sk}")
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril()
        scores = torch.where(mask, scores,
                             torch.tensor(NEG_INF, device=q.device))
    probs = softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


__all__ = ["NEG_INF", "attention", "softmax"]
