"""Analytic FLOPs, bytes and MFU accounting — the port's copy of the JAX
package's ``obs/flops.py``, with the card's own peaks.

The trainer's metrics rows (``train/loop.py``) and, later, the port's
bench compute MFU from this one module, with the JAX package's
conventions unchanged:

- matmul FLOPs are 6*MACs per training step (forward 2*MACs, backward
  4*MACs: dW and dx each cost one matmul per layer);
- attention is 4*B*H*S^2*Dh forward (QK^T and P@V at 2 FLOPs/MAC),
  halved under causal masking, and 3.5x forward for fwd+bwd (the
  backward's ~5 matmuls: p recompute, dp, dq, dk, dv);
- MFU divides by the card's dense bf16 peak (the tensor cores' native
  input width); for f32 runs this is conservative.

The peaks are looked up by ``torch.cuda.get_device_name``.  On the CPU,
or on a card the tables do not name, ``chip_peak_flops`` and
``chip_peak_hbm_bytes`` return None and MFU and ``hbm_frac`` are null:
the number is never made up.
"""

from __future__ import annotations

from typing import Optional

import torch

# dense bf16 tensor-core peak per card (NVIDIA's data sheet, SXM part,
# at its 700 W limit), by torch.cuda.get_device_name
PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,
}

# HBM bandwidth per card (bytes/s), by torch.cuda.get_device_name: the
# decode roofline's denominator, as PEAK_BF16_FLOPS is the MFU's
PEAK_HBM_BYTES = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def _card_name(device) -> Optional[str]:
    """The card's name for a CUDA ``device`` (default: the current
    card); None for any other device type or without a card."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name(device)


def chip_peak_flops(device=None) -> Optional[float]:
    """Per-card dense bf16 peak for ``device`` (a ``torch.device``;
    default: the current card); None on the CPU or for a card the table
    does not name — MFU is then undefined (reported as null, never
    fabricated)."""
    name = _card_name(device)
    return PEAK_BF16_FLOPS.get(name) if name else None


def chip_peak_hbm_bytes(device=None) -> Optional[float]:
    """Per-card HBM bandwidth for ``device``; None on the CPU or for an
    unknown card — hbm_frac is then undefined (null, never
    fabricated)."""
    name = _card_name(device)
    return PEAK_HBM_BYTES.get(name) if name else None


def mlp_flops_per_step(hidden_sizes, batch, input_size=784, num_classes=10):
    """Analytic fwd+bwd matmul FLOPs for the MLP family: 2*MACs fwd,
    4*MACs bwd (dW and dx each cost one matmul per layer) = 6*MACs
    total, per example."""
    sizes = (input_size, *hidden_sizes, num_classes)
    macs = sum(sizes[i] * sizes[i + 1] for i in range(len(sizes) - 1))
    return 6.0 * batch * macs


def attention_flops(b: int, s: int, h: int, d: int, causal: bool,
                    grad: bool = False) -> float:
    """Analytic attention FLOPs: forward = 4*B*H*S^2*D (QK^T and P@V,
    2 FLOPs per MAC), halved under causal masking; a value+grad call
    adds the backward's ~5 matmuls (p recompute, dp, dq, dk, dv) for
    ~2.5x forward on top."""
    f = 4.0 * b * h * float(s) * s * d * (0.5 if causal else 1.0)
    return f * 3.5 if grad else f


def model_flops_per_step(spec, batch: int) -> float:
    """Fwd+bwd FLOPs per training step for any model spec the trainer
    builds (``train/loop.make_spec``)."""
    from ..models import mlp, transformer

    if isinstance(spec, mlp.MLPSpec):
        return mlp_flops_per_step(tuple(spec.hidden_sizes), batch,
                                  input_size=spec.input_size,
                                  num_classes=spec.num_classes)
    if isinstance(spec, transformer.TransformerSpec):
        # the same 6*MACs + 3.5x-forward attention conventions
        return transformer.flops_per_step(spec, batch)
    raise TypeError(f"no FLOPs accounting for spec type {type(spec)!r}")


def tokens_per_example(spec):
    """Tokens one example contributes per step (for tokens/sec rows);
    None for families without a token axis (the MLP)."""
    seq = getattr(spec, "seq_len", None)
    return int(seq) if seq else None


def mfu(flops_per_step: float, steps_per_sec: float, peak,
        n_devices: int = 1):
    """Model FLOPs utilization against the cards' aggregate bf16 peak;
    None when the peak is unknown (the CPU, an unlisted card)."""
    if not peak:
        return None
    return flops_per_step * steps_per_sec / (peak * max(n_devices, 1))


# ---- decode roofline ----
#
# Autoregressive decode at serving batch sizes is bandwidth-bound: every
# step streams the full weight set plus the live KV cache through HBM to
# produce one token per sequence, so its utilization number is achieved
# bytes/s against the card's HBM bandwidth ("hbm_frac"), not MFU.


def decode_weight_bytes(spec) -> float:
    """Bytes of parameters one decode step streams from HBM: every
    weight is read once per token (batch-invariant)."""
    from ..models import transformer

    if not isinstance(spec, transformer.TransformerSpec):
        raise TypeError(f"no decode accounting for spec type "
                        f"{type(spec)!r}")
    return float(transformer.num_params(spec)) * spec.param_dtype.itemsize


def decode_kv_bytes_per_step(spec, batch: int, kv_len: float,
                             heads: int | None = None,
                             kv_dtype_bytes: float | None = None) -> float:
    """KV-cache traffic of one decode step at ``kv_len`` cached positions
    per sequence: every block reads its [kv_len, H, Dh] k and v per
    sequence and writes one new row of each, at ``kv_dtype_bytes`` per
    element — default: the compute dtype's itemsize (what the
    unquantized pool stores); 1 for the ``--kv_quant=int8`` pool, whose
    f32 scale planes are the separate
    ``decode_kv_scale_bytes_per_step`` term.  ``kv_len`` may be
    fractional (a mean over a decode's positions)."""
    h = heads or spec.n_heads
    if kv_dtype_bytes is None:
        kv_dtype_bytes = spec.compute_dtype.itemsize
    row = h * spec.d_head * float(kv_dtype_bytes)
    return 2.0 * spec.num_blocks * batch * (kv_len + 1.0) * row


def decode_kv_scale_bytes_per_step(spec, batch: int, kv_len: float,
                                   heads: int | None = None) -> float:
    """The int8 pools' scale-plane traffic per decode step: one f32 per
    cached (row, head) on each of the k/v planes — ``4 / Dh`` of the
    int8 payload."""
    h = heads or spec.n_heads
    return 2.0 * spec.num_blocks * batch * (kv_len + 1.0) * h * 4.0


def decode_bytes_per_step(spec, batch: int, kv_len: float,
                          heads: int | None = None,
                          kv_dtype_bytes: float | None = None) -> float:
    """Analytic HBM bytes per decode step: weights (read once) + KV
    read/write.  Activations are excluded (O(B*d) per block)."""
    return decode_weight_bytes(spec) \
        + decode_kv_bytes_per_step(spec, batch, kv_len, heads=heads,
                                   kv_dtype_bytes=kv_dtype_bytes)


def hbm_frac(bytes_per_step: float, step_time_s: float, peak,
             n_devices: int = 1):
    """Achieved HBM bandwidth as a fraction of the cards' peak; None
    when the peak is unknown."""
    if not peak or step_time_s <= 0:
        return None
    return bytes_per_step / step_time_s / (peak * max(n_devices, 1))


# ---- cross-replica communication volume ----
#
# Deterministic closed forms for the collective bytes of synchronous
# data parallelism and of multi-site local SGD (whose outer sync moves
# the f32 pseudo-gradient, or an int8 one plus per-leaf scales).


def num_params(spec) -> int:
    """Parameter count for any model spec the trainer builds."""
    from ..models import mlp, transformer

    if isinstance(spec, mlp.MLPSpec):
        return mlp.num_params(spec)
    if isinstance(spec, transformer.TransformerSpec):
        return transformer.num_params(spec)
    raise TypeError(f"no parameter accounting for spec type "
                    f"{type(spec)!r}")


def allreduce_bytes_per_replica(payload_bytes: float, n: int) -> float:
    """Bytes one replica moves (send + receive) in a bandwidth-optimal
    ring all-reduce of ``payload_bytes`` across ``n`` replicas:
    ``2 * (n-1)/n * payload``; 0 for n <= 1."""
    if n <= 1:
        return 0.0
    return 2.0 * (n - 1) / n * float(payload_bytes)


def sync_dp_comm_bytes_per_step(spec, dp: int,
                                itemsize: int | None = None) -> float:
    """Per-replica bytes the synchronous data-parallel gradient
    all-reduce moves every step: the full gradient set, in the param
    dtype unless ``itemsize`` overrides."""
    if itemsize is None:
        itemsize = getattr(spec, "param_dtype", torch.float32).itemsize
    return allreduce_bytes_per_replica(num_params(spec) * itemsize, dp)


def local_sgd_comm_bytes_per_round(spec, sites: int) -> float:
    """Per-site bytes one multi-site outer sync moves: the f32
    pseudo-gradient all-reduce across sites."""
    return allreduce_bytes_per_replica(num_params(spec) * 4, sites)


def num_param_leaves(spec) -> int:
    """Leaf count of the model's parameter dict."""
    from ..models import mlp, transformer

    if isinstance(spec, mlp.MLPSpec):
        # W1..WL + b1..bL
        return 2 * (len(spec.layer_sizes) - 1)
    if isinstance(spec, transformer.TransformerSpec):
        return len(transformer.param_shapes(spec))
    raise TypeError(f"no parameter accounting for spec type "
                    f"{type(spec)!r}")


def local_sgd_outer_quant_bytes_per_round(spec, sites: int) -> float:
    """Per-site bytes of the int8 outer sync: one byte per param plus
    one f32 scale per parameter leaf."""
    payload = num_params(spec) * 1 + num_param_leaves(spec) * 4
    return allreduce_bytes_per_replica(payload, sites)


def comm_bytes_per_token(bytes_per_step: float, batch: int,
                         tokens_each: int | None) -> float:
    """Collective bytes amortized per trained token (token-less
    families count one "token" per example)."""
    return bytes_per_step / (batch * (tokens_each or 1))
