"""Paged/block KV cache + the paged decode and prefill steps.

The pool holds, per block, ``k{i}/v{i}`` tensors ``[num_pages,
page_size, H, Dh]`` in the compute dtype, allocated once; a ``[B, W]``
block table maps each sequence's logical positions to pages (position
``j`` of row ``b`` lives at page ``table[b, j // page_size]``, row
``j % page_size``); page 0 is the scratch page that dead batch slots
and padded prefill rows write and nothing reads.

``paged_decode_step`` runs ``models/transformer._decode_forward`` —
the same math as the contiguous ``decode_step``, only the cache
adapter differs — and ``prefill_into_pages`` runs the block forward
over whole prompts at once and scatters their keys/values into the
pages.  Both update the pool in place (``ops/paged_attention``).

An int8 pool (``quant='int8'``) stores every cached row quantized
symmetrically over its Dh lane, with a per-row, per-head f32 scale
plane beside each pool; the adapter dequantizes the gathered view back
to the compute dtype, so the attention math is the same for both pools.
The quantize and dequantize are plain PyTorch (``ops/quant.py``), as
they are plain ``jnp`` in the JAX package.

A MoE spec is routed by exact dense dispatch in the prefill and the
decode, whatever ``spec.moe_dispatch`` says, as in the JAX package.

``sample_tokens`` picks greedy or temperature sampling per sequence on
the device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..device import DeviceLike, resolve_device
from ..models import transformer as tfm
from ..models.mlp import _ACTIVATIONS
from ..obs import tracer as tracer_lib
from ..ops import paged_attention as pa
from ..ops import quant as quant_lib

# valid --kv_quant values ("" = the compute-dtype pool)
KV_QUANTS = ("", "int8")


def local_heads(spec: tfm.TransformerSpec, params) -> int:
    """The cache's head count: the heads ``Wqkv``'s columns hold."""
    return int(params["L0_Wqkv"].shape[-1]) // spec.d_head


def init_paged_cache(spec: tfm.TransformerSpec, num_pages: int,
                     page_size: int, heads: Optional[int] = None,
                     quant: str = "", device: DeviceLike = None) -> dict:
    """The page pool ``{k{i}/v{i}: [num_pages, page_size, H, Dh]}`` in
    the compute dtype (the cache stores the same rounded k/v the
    attention consumes).  ``quant='int8'`` stores the pools as int8,
    each with an f32 scale plane ``k{i}_s``/``v{i}_s`` [num_pages,
    page_size, H]: (Dh + 4) / (2 Dh) of a bf16 pool's bytes."""
    if quant not in KV_QUANTS:
        raise ValueError(f"kv quant {quant!r}: expected one of "
                         f"{list(KV_QUANTS)}")
    dev = resolve_device(device)
    shape = (num_pages, page_size, heads or spec.n_heads, spec.d_head)
    dtype = torch.int8 if quant == "int8" else spec.compute_dtype
    cache = {}
    for i in range(spec.num_blocks):
        for name in (f"k{i}", f"v{i}"):
            cache[name] = torch.zeros(shape, dtype=dtype, device=dev)
            if quant == "int8":
                cache[f"{name}_s"] = torch.zeros(
                    shape[:3], dtype=torch.float32, device=dev)
    return cache


@dataclasses.dataclass
class PagedKV:
    """Cache adapter for ``transformer._decode_forward``: writes each
    block's new row through the block table (in place) and returns the
    gathered page view and the ragged-length mask.  ``pos`` is [B].
    An int8 pool (scale planes present) quantizes each new row per head
    on the way in and dequantizes the gathered view to
    ``dequant_dtype`` on the way out."""

    page_size: int
    cache: dict
    block_table: torch.Tensor     # [B, W] int
    pos: torch.Tensor             # [B] int
    dequant_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        self._page_ids, self._rows = pa.page_row_index(
            self.pos, self.block_table, self.page_size)
        kvw = self.block_table.shape[1] * self.page_size
        self.valid = pa.length_mask(kvw, self.pos)[:, None, :]
        self.quantized = "k0_s" in self.cache

    def _put(self, name: str, vals):
        """Scatter one row per sequence into pool ``name`` (and its
        scale plane when quantized); returns the gathered [B, S_kv, H,
        Dh] view in the attention's dtype."""
        if not self.quantized:
            pool = pa.scatter_kv_rows(self.cache[name], self._page_ids,
                                      self._rows, vals)
            return pa.gather_kv(pool, self.block_table)
        with tracer_lib.scope("quant"):
            q, s = quant_lib.quantize_int8(vals, axis=-1)   # [B, H, (1)]
        pool = pa.scatter_kv_rows(self.cache[name], self._page_ids,
                                  self._rows, q)
        plane = pa.scatter_kv_rows(self.cache[f"{name}_s"], self._page_ids,
                                   self._rows, s[..., 0])
        cq = pa.gather_kv(pool, self.block_table)           # int8
        cs = pa.gather_kv(plane, self.block_table)          # [B, S, H]
        with tracer_lib.scope("quant"):
            return quant_lib.dequantize_int8(cq, cs[..., None],
                                             self.dequant_dtype)

    def update(self, i: int, kk, vv):
        # gather AFTER the write: position pos attends to itself
        return self._put(f"k{i}", kk), self._put(f"v{i}", vv), self.valid


def _page_size(cache) -> int:
    return int(cache["k0"].shape[1])


@torch.no_grad()
def paged_decode_step(spec: tfm.TransformerSpec, params, cache,
                      block_table, token, pos):
    """One decode step over the paged cache: ``token``/``pos`` [B]
    (ragged positions), keys/values gathered over the block table's
    pages only; returns (logits [B, V], cache) with the cache updated
    in place."""
    kv = PagedKV(page_size=_page_size(cache), cache=cache,
                 block_table=block_table, pos=pos.long(),
                 dequant_dtype=spec.compute_dtype)
    logits = tfm._decode_forward(spec, params, token.long(), pos.long(), kv)
    return logits, cache


@torch.no_grad()
def prefill_into_pages(spec: tfm.TransformerSpec, params, cache,
                       block_table, tokens, lengths):
    """Prefill whole prompts with one batched forward: run the blocks
    over ``tokens`` [B, P] (P = the bucketed prompt width; rows past
    ``lengths[b]`` are pad), scatter every block's k/v rows into the
    pages, and return (logits at position ``lengths[b]-1`` [B, V],
    cache).  Causal attention keeps pad rows out of live positions.
    Attention is dense and MoE dispatch is dense whatever the spec
    says: the JAX package's prefill replaces them so (the decode path's
    conventions: exact routing, and the score math ``decode_step``
    mirrors), and so does this one.  An int8 pool gets each row
    quantized per head, with its scale plane, as the decode adapter
    writes it."""
    if spec.objective != "lm":
        raise ValueError("prefill serves the lm objective only")
    if not spec.causal:
        raise ValueError("prefill requires a causal spec (lm decode)")
    if spec.moe_dispatch != "dense" or spec.attention != "dense":
        spec = dataclasses.replace(spec, moe_dispatch="dense",
                                   attention="dense")
    cdt = spec.compute_dtype
    b, p = tokens.shape
    tokens = tokens.long()
    h = (params["W_emb"].to(torch.float32)[tokens]
         + params["pos"].to(torch.float32)[None, :p])       # [B, P, D]
    act = _ACTIVATIONS[spec.activation]
    page_ids, rows = pa.prefill_page_rows(p, block_table.long(),
                                          _page_size(cache))
    quantized = "k0_s" in cache

    def put(name, vals):
        """[B, P, H, Dh] rows into pool ``name`` (and its scale plane
        when the pool is int8)."""
        if not quantized:
            pa.scatter_prefill_rows(cache[name], page_ids, rows, vals)
            return
        with tracer_lib.scope("quant"):
            q, s = quant_lib.quantize_int8(vals, axis=-1)
        pa.scatter_prefill_rows(cache[name], page_ids, rows, q)
        pa.scatter_prefill_rows(cache[f"{name}_s"], page_ids, rows,
                                s[..., 0])

    for i in range(spec.num_blocks):
        kv_out: list = []
        h, _ = tfm._block_forward(spec, tfm._block_params(params, i), h,
                                  act, cdt, kv_out=kv_out)
        (kk, vv), = kv_out                                # [B, P, H, Dh]
        put(f"k{i}", kk)
        put(f"v{i}", vv)
    # the head only at each prompt's last position
    idx = (lengths.long() - 1)[:, None, None].expand(b, 1, h.shape[-1])
    last = torch.gather(h, 1, idx)[:, 0]
    hf = tfm._ln(spec, last, params["lnf_g"], params["lnf_b"])
    logits = tfm._mm(params, hf, "W_head", "b_head", cdt).to(torch.float32)
    return logits, cache


def sample_tokens(logits: torch.Tensor, generator: Optional[torch.Generator],
                  temperature: torch.Tensor) -> torch.Tensor:
    """Greedy argmax where ``temperature[b] <= 0``, a categorical draw
    at ``logits / temperature[b]`` otherwise, for the whole batch on
    the device.  ``generator=None`` means every row is greedy (the
    engine passes None when no row samples, and draws no noise)."""
    greedy = torch.argmax(logits, dim=-1)
    if generator is None:
        return greedy
    temperature = temperature.to(torch.float32)
    safe = torch.where(temperature > 0, temperature,
                       torch.ones_like(temperature))
    sampled = tfm._gumbel_argmax(logits / safe[:, None], generator)
    return torch.where(temperature > 0, sampled, greedy)


__all__ = ["KV_QUANTS", "local_heads", "init_paged_cache", "PagedKV",
           "paged_decode_step", "prefill_into_pages", "sample_tokens"]
