"""Plain single-device attention (``[B, S, H, D]`` layout), the mask
constant the decode path shares, and sequence-parallel ring attention
(the JAX package's ``ops/ring_attention.py``).

The ring: q, k and v arrive as this rank's contiguous block ``[B, S/n,
H, D]`` of the token axis (the seq axis of ``parallel/mesh.py``, rank at
seq index i holding positions ``[i*S/n, (i+1)*S/n)``).  Each rank keeps
its q block and meets one k/v block a ring step, combining them with the
online-softmax recurrence (running max ``m``, normaliser ``l``,
un-normalised output ``o``: a reassociation of one full softmax, not an
approximation); after each step the k/v block moves to seq index + 1
(``parallel/mesh.rotate_start``, JAX's ``ppermute``).  Causal masking is
by global position, recovered from the ring step.

- ``ring_attention``: the dense ring (``_block`` per step),
  differentiable by autograd through ``parallel/mesh.seq_rotate``;
- ``ring_flash_attention``: each block pair through the flash kernels
  (``ops/flash_attention.flash_forward(..., stats=True)``, B5's stats
  form), merged across steps by ``_merge_partials``.  Under causal
  masking a block is classified once a step: future blocks are skipped,
  the diagonal block runs the causal kernel, past blocks the non-causal
  one.  Its backward (``_RingFlash``) is a second ring in which each k/v
  block travels with its f32 dk/dv accumulators, every rank adding its
  (q block x visiting block) part through B6 and B7 (``flash_dq``,
  ``flash_dkv``) from the forward's saved statistics, with
  ``dlt = rowsum(do * o)`` hoisted out of the loop; the accumulators
  rotate every step, so n rotations bring them home, while dq
  accumulates locally.  Each rotation is posted before the step's
  kernels and waited for after them, so the transfer overlaps the
  block's work.  JAX's dispatch: a local block that is not a multiple of
  256, or unequal q/k lengths, takes the dense ring.  The JAX package
  also sends its CPU backend to the dense ring (its interpret-mode
  kernels cannot run inside ``shard_map``); the port runs the flash ring
  on the CPU too, on the kernels' plain versions.

Without a live seq axis (None, one rank) both are plain attention over
the local block.
"""

from __future__ import annotations

import math

import torch

from ..parallel.mesh import rotate_start, seq_rotate

# large-negative instead of -inf: keeps exp() NaN-free for rows that
# are fully masked
NEG_INF = -1e30


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``exp(x - max) / sum`` — the op order of ``jax.nn.softmax``
    (``torch.softmax`` multiplies by the reciprocal of the sum, which
    rounds differently)."""
    e = torch.exp(x - torch.amax(x, dim=dim, keepdim=True))
    return e / torch.sum(e, dim=dim, keepdim=True)


def _scale(q: torch.Tensor) -> torch.Tensor:
    """1/sqrt(d) taken in double and rounded to f32 once, as numpy's
    scalar is in the JAX version."""
    return torch.tensor(1.0 / math.sqrt(q.shape[-1]),
                        dtype=torch.float32).to(q.device)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = False) -> torch.Tensor:
    """Softmax attention over [B, S, H, D] inputs.  The score product
    runs in the inputs' dtype and is cast to f32 after (bf16 rounding
    included), the mask is ``NEG_INF``, and the probabilities are
    cast to ``v.dtype`` before the value product — the JAX package's
    rounding points.  Under ``causal`` the q and k lengths must be
    equal."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) \
        * _scale(q)
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


def _block(q, k, v, m, l, o, q_off: int, k_off: int, causal: bool):
    """One online-softmax step for a (q block, k/v block) pair: q ``[B,
    Lq, H, D]``, k/v ``[B, Lk, H, D]``, m/l ``[B, H, Lq]``, o ``[B, Lq,
    H, D]`` un-normalised f32; the offsets are the blocks' global first
    positions (the causal mask)."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) \
        * _scale(q)
    if causal:
        lq, lk = scores.shape[-2], scores.shape[-1]
        q_pos = q_off + torch.arange(lq, device=q.device)
        k_pos = k_off + torch.arange(lk, device=q.device)
        mask = k_pos[None, :] <= q_pos[:, None]
        scores = torch.where(mask, scores,
                             torch.tensor(NEG_INF, device=q.device))
    m_new = torch.maximum(m, torch.amax(scores, dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(scores - m_new[..., None])
    # a fully masked row keeps m_new == NEG_INF, where exp(0) would
    # weigh every masked key 1: zero them
    p = torch.where(scores <= NEG_INF / 2, torch.zeros((), device=q.device),
                    p)
    l_new = l * alpha + torch.sum(p, dim=-1)
    o_new = o * alpha.transpose(1, 2)[..., None] + torch.einsum(
        "bhqk,bkhd->bqhd", p, v.to(torch.float32))
    return m_new, l_new, o_new


def ring_attention(q, k, v, axis, causal: bool = False):
    """Sequence-parallel attention, the dense ring: this rank's output
    block ``[B, S/n, H, D]`` in q's dtype.  ``axis``: the seq axis
    (``parallel/mesh.SeqAxis``); None or one rank: the block attends
    to itself alone.  Differentiable by autograd."""
    n = 1 if axis is None else axis.size
    idx = 0 if axis is None else axis.index
    b, lq, h, d = q.shape
    lk = k.shape[1]
    f32 = torch.float32
    m = torch.full((b, h, lq), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((b, h, lq), dtype=f32, device=q.device)
    o = torch.zeros((b, lq, h, d), dtype=f32, device=q.device)
    k_t, v_t = k, v
    for t in range(n):
        # at step t this rank holds the block that started at idx - t
        k_off = ((idx - t) % n) * lk
        m, l, o = _block(q, k_t, v_t, m, l, o, idx * lq, k_off, causal)
        if t < n - 1:
            k_t, v_t = seq_rotate(k_t, axis), seq_rotate(v_t, axis)
    out = o / torch.clamp_min(l, 1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def _merge_partials(m, l, o, m_b, l_b, acc_b):
    """Two un-normalised softmax partials combined by their (max,
    normaliser) statistics: m/l ``[B, L, H, 1]``, o/acc ``[B, L, H,
    D]``."""
    m_new = torch.maximum(m, m_b)
    a = torch.exp(m - m_new)
    bb = torch.exp(m_b - m_new)
    return m_new, l * a + l_b * bb, o * a + acc_b * bb


def _kernel_stats(q, k, v, causal: bool):
    """B5's stats form, ``(acc [B,L,H,D], m, l [B,L,H,1])``: the kernel
    on CUDA tensors, its plain version on CPU ones."""
    from .flash_attention import flash_forward

    acc, m, l = flash_forward(q, k, v, causal, stats=True)
    return acc, m[..., None], l[..., None]


def _ring_flash_impl(q, k, v, axis, causal: bool):
    """The forward ring on B5's stats form (``_kernel_stats``):
    returns ``(o in q's dtype, m, l)``, m and l ``[B, L, H]`` f32 (the
    backward's residuals).  The k/v pair travels as one stacked buffer,
    its rotation posted before the step's kernel and waited for after."""
    n = 1 if axis is None else axis.size
    idx = 0 if axis is None else axis.index
    b, lq, h, d = q.shape
    f32 = torch.float32
    m = torch.full((b, lq, h, 1), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((b, lq, h, 1), dtype=f32, device=q.device)
    o = torch.zeros((b, lq, h, d), dtype=f32, device=q.device)
    kv = torch.stack([k, v])
    for t in range(n):
        rel = (idx - t) % n      # the block of the sequence held now
        pending = rotate_start([kv], axis) if t < n - 1 else None
        if not causal or rel < idx:
            acc_b, m_b, l_b = _kernel_stats(q, kv[0], kv[1], False)
            m, l, o = _merge_partials(m, l, o, m_b, l_b, acc_b)
        elif rel == idx:
            acc_b, m_b, l_b = _kernel_stats(q, kv[0], kv[1], True)
            m, l, o = _merge_partials(m, l, o, m_b, l_b, acc_b)
        if pending is not None:
            kv = pending.wait()[0]
    out = (o / torch.clamp_min(l, 1e-30)).to(q.dtype)
    return out, m[..., 0], l[..., 0]


class _RingFlash(torch.autograd.Function):
    """The flash ring with its own backward ring (JAX's
    ``_ring_flash_diff`` with ``_rf_fwd``/``_rf_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, axis, causal):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, m, l = _ring_flash_impl(q, k, v, axis, causal)
        ctx.axis, ctx.causal = axis, causal
        ctx.save_for_backward(q, k, v, o, m, l)
        return o

    @staticmethod
    def backward(ctx, g):
        from .flash_attention import flash_dkv, flash_dq

        q, k, v, o, m, l = ctx.saved_tensors
        axis, causal = ctx.axis, ctx.causal
        n = 1 if axis is None else axis.size
        idx = 0 if axis is None else axis.index
        do = g.to(q.dtype).contiguous()
        dlt = torch.sum(do.to(torch.float32) * o.to(torch.float32), dim=-1)
        kv = torch.stack([k, v])
        dkv = torch.zeros(kv.shape, dtype=torch.float32, device=q.device)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        moving = None            # the accumulators' rotation in flight
        for t in range(n):
            rel = (idx - t) % n
            pending = rotate_start([kv], axis) if t < n - 1 else None
            part = None
            if not causal or rel <= idx:
                c = causal and rel == idx
                dq += flash_dq(q, kv[0], kv[1], do, m, l, dlt, c)
                part = flash_dkv(q, kv[0], kv[1], do, m, l, dlt, c)
            if moving is not None:
                dkv = moving.wait()[0]
            if part is not None:
                dkv[0] += part[0]
                dkv[1] += part[1]
            moving = rotate_start([dkv], axis)
            if pending is not None:
                kv = pending.wait()[0]
        dkv = moving.wait()[0]
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None)


def ring_flash_attention(q, k, v, axis, causal: bool = False):
    """Ring attention on the flash kernels (JAX's dispatch): a local
    block that is not a multiple of 256, or unequal q/k lengths, takes
    the dense ``ring_attention``; otherwise the flash ring, through
    ``_RingFlash`` under autograd."""
    from .flash_attention import _BLK

    lq = q.shape[1]
    if lq % _BLK or k.shape[1] != lq:
        return ring_attention(q, k, v, axis, causal)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _RingFlash.apply(q, k, v, axis, causal)
    return _ring_flash_impl(q.contiguous(), k.contiguous(), v.contiguous(),
                            axis, causal)[0]


__all__ = ["NEG_INF", "attention", "softmax", "ring_attention",
           "ring_flash_attention"]
