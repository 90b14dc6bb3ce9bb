"""Ulysses sequence parallelism: the head <-> sequence all-to-all (the
JAX package's ``ops/ulysses_attention.py``).

The second of the two sequence-parallel layouts beside the ring
(``ops/ring_attention.py``): one ``all_to_all`` re-shards q, k and v
together from sequence-sharded ``[B, S/n, H, D]`` to head-sharded
``[B, S, H/n, D]``, every rank then runs ordinary attention over the
whole sequence for its heads (the flash kernels, B5-B7, or the dense
``attention``), and a second exchange re-shards the output back.  The
exchange runs over the seq axis (``parallel/mesh.seq_all_to_all``,
JAX's ``all_to_all``), whose backward is the reverse exchange, so
autograd carries the gradients through both.  The head count must
split over the axis.
"""

from __future__ import annotations

import torch

from ..parallel.mesh import seq_all_to_all


def ulysses_attention(q, k, v, axis, causal: bool = False,
                      use_flash: bool = False):
    """Sequence-parallel attention by the head <-> sequence exchange.
    ``q``, ``k``, ``v``: this rank's token block ``[B, S/n, H, D]``, all
    heads; ``axis``: the seq axis (``parallel/mesh.SeqAxis``; None or
    one rank: plain attention).  ``use_flash`` runs the flash kernels
    on the gathered sequence (``ops/flash_attention.flash_attention``),
    else the dense ``attention``.  Returns ``[B, S/n, H, D]``."""
    n = 1 if axis is None else axis.size
    b, sl, heads, d = q.shape
    if heads % n:
        raise ValueError(
            f"ulysses sequence parallelism needs n_heads ({heads}) "
            f"divisible by the sequence-axis size ({n})")
    if n == 1:
        qg, kg, vg = q, k, v
    else:
        # [3, B, S/n, H, D] -> chunk j (heads [j H/n, (j+1) H/n)) to seq
        # index j: one exchange for q, k and v
        x = torch.stack((q, k, v)).reshape(3, b, sl, n, heads // n, d)
        x = seq_all_to_all(x.permute(3, 0, 1, 2, 4, 5), axis)
        # chunk j came from seq index j: tokens [j S/n, (j+1) S/n)
        x = x.permute(1, 2, 0, 3, 4, 5).reshape(3, b, n * sl, heads // n, d)
        qg, kg, vg = x[0], x[1], x[2]
    if use_flash:
        from .flash_attention import flash_attention

        out = flash_attention(qg, kg, vg, causal)
    else:
        from .ring_attention import attention

        out = attention(qg, kg, vg, causal=causal)
    if n == 1:
        return out
    # [B, S, H/n, D] -> chunk j (tokens of seq index j) back to it
    y = seq_all_to_all(out.reshape(b, n, sl, heads // n, d)
                       .permute(1, 0, 2, 3, 4), axis)
    # chunk j came from seq index j: heads [j H/n, (j+1) H/n)
    return y.permute(1, 2, 0, 3, 4).reshape(b, sl, heads, d)


__all__ = ["ulysses_attention"]
