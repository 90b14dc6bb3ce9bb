"""ZeRO-1: optimizer slots sharded 1/dp over the data axis (the JAX
package's ``parallel/zero.py``), composed with tensor parallelism.

The params stay replicated; every float optimizer slot is kept as one
flat chunk a rank.  Each param leaf is flattened and zero-padded to
``dp * chunk`` elements, ``chunk = ceil(size / dp)``, and rank r owns
elements ``[r*chunk, (r+1)*chunk)``: it holds that chunk of every slot,
applies the optimizer to that chunk of the (already all-reduced)
gradients and params, and one all-gather rebuilds the full updated
params on every rank.  The optimizers are elementwise, so each rank's
chunk update is the full update restricted to its slice.  The padded
tail stays zero: a zero gradient on a zero param leaves zero slots.

Under ``--model_parallel`` (and ``--expert_parallel``) the chunking runs
on the **local** (already Megatron- or expert-split) flat view of each
leaf, the chunk index is the rank's data index and the all-gather runs
over its data group, as JAX chunks each device's local block.

Under ``--pipeline_parallel`` the chunking runs on the local view of
each stacked ``blk_*`` leaf too (this stage's blocks, then its Megatron
or expert shard of them), as JAX chunks each device's block.

On disk a slot leaf has JAX's global layout: ``[dp, chunk]`` for a
replicated leaf (data index d's chunk is row d), ``[mp, dp, chunk]`` for
a leaf split over the model axis and ``[ep, dp, chunk]`` for an expert
leaf, and under pipeline parallelism ``[pp, (mp | ep,) dp, chunk]`` for
a ``blk_*`` leaf (JAX's ``[|ax1|, ..., dp, chunk]``, the axes in dim
order), so a checkpoint crosses between the packages.  Resuming
needs the same ``dp``: the trainer checks the ``zero_dp`` extra.
ZeRO-1 runs on the host path, as in JAX.
"""

from __future__ import annotations

import math

import torch

from .. import cluster
from ..train.optim import tree_map


def chunk_len(local_size: int, dp: int) -> int:
    return max(1, math.ceil(local_size / dp))


def zero_opt_state(optimizer, params: dict, dp: int):
    """This rank's optimizer state: ``optimizer.init`` over a
    ``[chunk]`` zero leaf a param, so every float slot is this rank's
    row of JAX's ``[dp, chunk]`` layout (integer counters stay
    scalars)."""
    templ = {k: torch.zeros(chunk_len(a.numel(), dp), dtype=a.dtype,
                            device=a.device)
             for k, a in params.items()}
    return optimizer.init(templ)


def _chunk_of(a: torch.Tensor, dp: int, rank: int) -> torch.Tensor:
    flat = a.reshape(-1)
    chunk = chunk_len(flat.numel(), dp)
    pad = chunk * dp - flat.numel()
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat[rank * chunk:(rank + 1) * chunk]


def zero_update(optimizer, grads: dict, opt_state, params: dict, dp: int,
                rank: int, group=None):
    """``(new_params, new_opt_state)``: the optimizer on chunk ``rank``
    (the data index) of the gradients, params and slots, then one
    all-gather a leaf over the data ``group`` (default the world) for
    the full updated (local) params.  ``grads`` must already be summed
    over the data axis (the sync step's all-reduce has run)."""
    g_c = {k: _chunk_of(g, dp, rank) for k, g in grads.items()}
    p_c = {k: _chunk_of(p, dp, rank) for k, p in params.items()}
    new_pc, new_oc = optimizer.update(g_c, opt_state, p_c)

    def gather(pc, like):
        full = pc
        if cluster.collectives():
            full = pc.new_empty(dp * pc.numel())
            cluster.all_gather_flat(full, pc.contiguous(), group=group)
        return full[:like.numel()].reshape(like.shape).to(like.dtype)

    return tree_map(gather, new_pc, params), new_oc


__all__ = ["chunk_len", "zero_opt_state", "zero_update"]
