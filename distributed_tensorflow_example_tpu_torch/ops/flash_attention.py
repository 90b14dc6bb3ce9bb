"""Blockwise (flash) attention: the wrappers of the port's hand-written
Hopper kernels, their plain versions, and the differentiable
``flash_attention`` (the JAX package's ``ops/flash_attention.py``).

========================  ===========================  ==============================
wrapper                   CUDA source (ops/csrc/)      TPU kernel it replaces
========================  ===========================  ==============================
flash_forward             bf16: flash_attention_tc.cu  flash_attention._make_kernel
                          f32: flash_attention.cu
flash_dq                  bf16: flash_attention_tc.cu  flash_attention._make_dq_kernel
                          f32: flash_attention.cu
flash_dkv                 flash_attention.cu           flash_attention._make_dkv_kernel
========================  ===========================  ==============================

The bf16 forward and dq run every product on the tensor cores
(warpgroup MMAs, wgmma, over bf16 tiles in shared memory fed by
asynchronous copies); f32 and dk/dv run f32 FMA on the CUDA cores (``flash_attention.cu``'s note
says why f32 stays there).

Layouts are the JAX package's: q, k, v, o and do are ``[B, S, H, D]``;
the softmax statistics m (natural log), l and ``dlt = rowsum(do * o)``
are ``[B, S, H]`` f32 (JAX keeps a trailing unit axis).  The math is the
JAX kernels', rounding points included: q is prescaled once by
``log2(e)/sqrt(D)`` and rounded back to its dtype, scores are f32 in the
log2 domain, ``p`` (forward and dk/dv) and ``ds`` are rounded to the
compute dtype (the inputs' dtype) before their products, and the
normalizer is floored at 1e-30.

``flash_forward(..., stats=False)`` is the normalized output (the JAX
``_flash_forward``), ``stats=True`` the raw ``(acc, m, l)`` (the JAX
``_flash_stats``); ``flash_dq``/``flash_dkv`` are the two backward
kernels (``_flash_backward_flat``).  For CPU tensors each runs its plain
version (``*_reference``: the same math over whole rows, no tiling); for
CUDA tensors it checks its inputs, launches and raises on a launch
error.  There is no fallback from a kernel to a plain version.  Each
counts its launches in ``launches`` (``ops/_counts.py`` reads them with
the other kernels') and keeps the ``[B, S, H, D]`` of its last launch
in ``last_shape`` (under tensor parallelism H is the rank's heads).

``flash_attention(q, k, v, causal)`` keeps the JAX dispatch: cross-length
q/k and non-causal S not a multiple of 256 run the dense
``ops/ring_attention.attention`` in both directions (where the JAX
package runs XLA); everything else runs the kernels.  Under autograd the
forward is the stats form, ``o = acc / max(l, 1e-30)`` is taken here,
and the backward is ``dlt`` in f32, then dq and dk/dv (the JAX
``_fwd``/``_bwd``); without autograd it is the normalized form.  Any S
runs the kernels without padding: rows and keys past S are guarded in
the kernels, which for the causal ragged case equals the JAX package's
zero padding.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build, _counts
from .fused import _DTYPE_CODES, _launch, _on_cpu, _require
from .ring_attention import NEG_INF, attention

_BLK = 256          # the JAX kernels' sequence alignment (dispatch rule)
_LOG2E = float(np.log2(np.e))
_LN2 = float(np.log(2.0))
_TINY = 1e-30


def _f32(v: float) -> torch.Tensor:
    """A constant rounded to f32 once, as JAX rounds a Python float
    that meets an f32 array."""
    return torch.tensor(v, dtype=torch.float32)


def _qscale(d: int) -> float:
    """f32(log2(e) / sqrt(d)): the prescale factor of the JAX
    ``_prescale``."""
    return float(np.float32(_LOG2E / np.sqrt(d)))


# ---------------------------------------------------------------------------
# plain versions (CPU tensors, and the yardstick on the card)
# ---------------------------------------------------------------------------


def _prescale(q):
    """``round_q.dtype(q * log2(e)/sqrt(D))``: scores from the result
    are natural-domain scores in log2 units."""
    c = _f32(_LOG2E / np.sqrt(q.shape[-1])).to(q.device)
    return (q.to(torch.float32) * c).to(q.dtype)


def _scores(q2, k, causal: bool):
    """f32 log2-domain scores ``[B, H, Sq, Sk]`` from the prescaled q
    and k (products of the compute-dtype values, summed in f32), with
    NEG_INF above the diagonal under ``causal``."""
    s = torch.einsum("bqhd,bkhd->bhqk", q2.to(torch.float32),
                     k.to(torch.float32))
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=s.device).tril()
        s = torch.where(mask, s, torch.tensor(NEG_INF, device=s.device))
    return s


def _bhs(t):
    """[B, H, S, 1] or [B, H, S] -> [B, S, H]."""
    if t.ndim == 4:
        t = t[..., 0]
    return t.transpose(1, 2).contiguous()


def _bh1(t):
    """[B, S, H] -> [B, H, S, 1]."""
    return t.transpose(1, 2)[..., None]


def flash_stats_reference(q, k, v, causal: bool = False):
    """``(acc f32 [B,S,H,D], m f32 [B,S,H], l f32 [B,S,H])``: the
    un-normalized output, the row max in the natural log domain and the
    normalizer, over whole rows (the JAX ``_flash_stats`` contract with
    the kernel's rounding points: p rounded to the compute dtype before
    p . v, l summed from the unrounded p)."""
    cdt = q.dtype
    s = _scores(_prescale(q), k.to(cdt), causal)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = torch.sum(p, dim=-1)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(cdt).to(torch.float32),
                       v.to(cdt).to(torch.float32))
    return acc, _bhs(m * _f32(_LN2).to(m.device)), _bhs(l)


def flash_attention_reference(q, k, v, causal: bool = False):
    """The normalized output ``round(acc / max(l, 1e-30))`` in q's
    dtype (the JAX ``_flash_forward``)."""
    acc, _m, l = flash_stats_reference(q, k, v, causal)
    return (acc / torch.clamp_min(l, _TINY)[..., None]).to(q.dtype)


def flash_backward_reference(q, k, v, do, m, l, dlt, causal: bool = False):
    """``(dq, dk, dv)`` f32 ``[B, S, H, D]`` from the forward's saved
    statistics (the JAX ``_bwd_tile`` math over whole rows): p
    recomputed as ``exp2(s - m log2(e)) / max(l, 1e-30)``, ``ds = p
    (dp - dlt)``; dq = round(ds) . k / sqrt(D), dk = round(ds)^T . q2 /
    log2(e), dv = round(p)^T . do."""
    cdt = q.dtype
    dev = q.device
    f32 = torch.float32
    q2 = _prescale(q)
    s = _scores(q2, k.to(cdt), causal)
    p = torch.exp2(s - _bh1(m) * _f32(_LOG2E).to(dev)) \
        / torch.clamp_min(_bh1(l), _TINY)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.to(cdt).to(f32),
                      v.to(cdt).to(f32))
    ds = p * (dp - _bh1(dlt))
    ds_c = ds.to(cdt).to(f32)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds_c, k.to(cdt).to(f32)) \
        * _f32(1.0 / np.sqrt(q.shape[-1])).to(dev)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds_c, q2.to(f32)) \
        * _f32(1.0 / _LOG2E).to(dev)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(cdt).to(f32),
                      do.to(cdt).to(f32))
    return dq, dk, dv


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check(q, k, v, do=None, stats=()):
    """The kernels' input contract: q, k, v (and do) contiguous
    ``[B, S, H, D]`` of one dtype (f32 or bf16), D <= the kernels'
    limit; the statistics (m, l, dlt) contiguous f32 ``[B, S, H]``."""
    _require("q", q, dtypes=_DTYPE_CODES)
    for name, t in (("k", k), ("v", v), ("do", do)):
        if t is not None:
            _require(name, t, shape=q.shape, dtypes=(q.dtype,))
    if q.ndim != 4:
        raise ValueError(f"q: expected [B, S, H, D], got {tuple(q.shape)}")
    for name, t in zip(("m", "l", "dlt"), stats):
        _require(name, t, shape=q.shape[:3], dtypes=(torch.float32,))
    limit = _build.load().dtx_flash_max_d()
    if q.shape[-1] > limit:
        raise ValueError(f"head dim {q.shape[-1]} exceeds the flash "
                         f"kernels' limit {limit} (wider heads are "
                         f"queued in ROADMAP.md)")


def flash_forward(q, k, v, causal: bool = False, stats: bool = False):
    """B5.  ``stats=False``: the normalized output ``[B, S, H, D]`` in
    q's dtype; ``stats=True``: ``(acc f32 [B,S,H,D], m, l f32
    [B,S,H])``.  Equal q/k lengths.  CUDA: one CTA per (q tile,
    batch*head) streaming 64-key tiles; bf16 ``flash_fwd_tc_kernel``
    (128-row q tiles, two warpgroups on the tensor cores), f32
    ``flash_fwd_kernel`` (64-row q tiles, f32 FMA)."""
    if _on_cpu(q, k, v):
        if stats:
            return flash_stats_reference(q, k, v, causal)
        return flash_attention_reference(q, k, v, causal)
    _check(q, k, v)
    b, s, h, d = q.shape
    dev = q.device
    if stats:
        o = None
        acc = torch.empty(q.shape, dtype=torch.float32, device=dev)
        m = torch.empty((b, s, h), dtype=torch.float32, device=dev)
        l = torch.empty((b, s, h), dtype=torch.float32, device=dev)
        ptrs = (0, acc.data_ptr(), m.data_ptr(), l.data_ptr())
    else:
        o = torch.empty(q.shape, dtype=q.dtype, device=dev)
        ptrs = (o.data_ptr(), 0, 0, 0)
    _launch("dtx_flash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            *ptrs, b, s, h, d, int(causal), int(stats),
            _DTYPE_CODES[q.dtype], _qscale(d))
    _counts.count(flash_forward)
    flash_forward.last_shape = (b, s, h, d)
    return (acc, m, l) if stats else o


def flash_dq(q, k, v, do, m, l, dlt, causal: bool = False):
    """B6: dq f32 ``[B, S, H, D]`` from the saved statistics.  CUDA: one
    CTA per (q tile, batch*head), streaming key tiles up to the causal
    frontier; bf16 ``flash_dq_tc_kernel`` (128-row q tiles, two
    warpgroups on the tensor cores), f32 ``flash_dq_kernel`` (64-row q
    tiles, f32 FMA)."""
    if _on_cpu(q, k, v, do, m, l, dlt):
        return flash_backward_reference(q, k, v, do, m, l, dlt, causal)[0]
    _check(q, k, v, do, (m, l, dlt))
    b, s, h, d = q.shape
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _launch("dtx_flash_bwd_dq", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), m.data_ptr(), l.data_ptr(), dlt.data_ptr(),
            dq.data_ptr(), b, s, h, d, int(causal), _DTYPE_CODES[q.dtype],
            _qscale(d), float(np.float32(1.0 / np.sqrt(d))))
    _counts.count(flash_dq)
    flash_dq.last_shape = (b, s, h, d)
    return dq


def flash_dkv(q, k, v, do, m, l, dlt, causal: bool = False):
    """B7: ``(dk, dv)`` f32 ``[B, S, H, D]`` from the saved statistics.
    CUDA: ``flash_dkv_kernel``, one CTA per (key tile, batch*head),
    streaming q tiles from the first that sees the key tile."""
    if _on_cpu(q, k, v, do, m, l, dlt):
        return flash_backward_reference(q, k, v, do, m, l, dlt, causal)[1:]
    _check(q, k, v, do, (m, l, dlt))
    b, s, h, d = q.shape
    dk = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _launch("dtx_flash_bwd_dkv", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), m.data_ptr(), l.data_ptr(), dlt.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, s, h, d, int(causal),
            _DTYPE_CODES[q.dtype], _qscale(d),
            float(np.float32(1.0 / _LOG2E)))
    _counts.count(flash_dkv)
    flash_dkv.last_shape = (b, s, h, d)
    return dk, dv


KERNEL_WRAPPERS = (flash_forward, flash_dq, flash_dkv)
_counts.register(*KERNEL_WRAPPERS)
for _w in KERNEL_WRAPPERS:
    _w.last_shape = None


# ---------------------------------------------------------------------------
# the differentiable attention (the JAX custom_vjp)
# ---------------------------------------------------------------------------


class _FlashAttention(torch.autograd.Function):
    """Forward: B5's stats form, then ``o = acc / max(l, 1e-30)`` in q's
    dtype (the JAX ``_fwd``); saves (q, k, v, o, m, l).  Backward:
    ``dlt = rowsum(do * o)`` in f32, B6 and B7, each gradient cast to
    its input's dtype (the JAX ``_bwd`` + ``_flash_backward``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        acc, m, l = flash_forward(q, k, v, causal, stats=True)
        o = (acc / torch.clamp_min(l, _TINY)[..., None]).to(q.dtype)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, o, m, l)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, m, l = ctx.saved_tensors
        do = g.to(q.dtype).contiguous()
        dlt = torch.sum(do.to(torch.float32) * o.to(torch.float32), dim=-1)
        dq = flash_dq(q, k, v, do, m, l, dlt, ctx.causal)
        dk, dv = flash_dkv(q, k, v, do, m, l, dlt, ctx.causal)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None


def flash_attention(q, k, v, causal: bool = False):
    """Attention over ``[B, S, H, D]`` with O(S) saved residuals: the
    flash kernels, or the dense ``attention`` for cross-length q/k and
    non-causal S not a multiple of 256 (the JAX dispatch)."""
    s = q.shape[1]
    if k.shape[1] != s or (s % _BLK and not causal):
        return attention(q, k, v, causal=causal)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal)
    return flash_forward(q.contiguous(), k.contiguous(), v.contiguous(),
                         causal)


__all__ = ["flash_attention", "flash_forward", "flash_dq", "flash_dkv",
           "flash_stats_reference", "flash_attention_reference",
           "flash_backward_reference", "KERNEL_WRAPPERS"]
