"""Flags of the port's serving front door.

The serving subset of the JAX package's ``config.py``, with the same
flag names and defaults, so one command line drives either package's
``serving/cli.py``.  Flags of features the port does not have yet are
still parsed, and the CLI refuses them with a message naming ROADMAP.md
instead of ignoring them.  ``--device`` is the port's own: the card
(``cuda``) unless ``cpu`` is asked for.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class Config:
    seed: int = 1
    # ---- model ----
    model: str = "mlp"              # the serving CLI needs transformer
    objective: str = "classify"     # ... and lm
    input_size: int = 784           # = seq_len for the lm objective
    vocab_size: int = 256
    d_model: int = 128
    n_heads: int = 4
    num_blocks: int = 2
    d_ff: int = 256
    activation: str = "sigmoid"     # sigmoid serves as gelu (JAX CLI rule)
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    num_experts: int = 0            # MoE: not ported yet
    fused_ln: bool = False          # LayerNorms through the fused kernels
    fp8_ffn: bool = False           # FFN on fp8-rounded operands
    checkpoint_dir: str = ""
    # ---- serving ----
    serve_port: int = 0
    decode_page_size: int = 16
    decode_pages: int = 0
    decode_max_batch: int = 8
    kv_quant: str = ""              # int8: not ported yet
    deadline_ms: float = 0.0
    max_queue: int = 0
    brownout: str = ""
    engine_retries: int = 0
    # not ported yet: the CLI refuses these when set
    trace_spans: bool = False
    slo: str = ""
    replicas: int = 1
    replay: str = ""
    # ---- the port's own ----
    device: Optional[str] = None    # None = cuda


def _pages(s: str) -> int:
    """0 (auto-size) or >= 2: page 0 is the reserved scratch page."""
    v = int(s)
    if v != 0 and v < 2:
        raise argparse.ArgumentTypeError(
            f"decode_pages {v} must be 0 (auto) or >= 2 (page 0 is "
            f"the reserved scratch page)")
    return v


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="distributed_tensorflow_example_tpu_torch.serving.cli",
        description="Serve POST /generate from the PyTorch port's "
                    "continuous-batching decode engine")
    d = Config()
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--model", type=str, default=d.model,
                   choices=["mlp", "transformer"])
    p.add_argument("--objective", type=str, default=d.objective,
                   choices=["classify", "lm"])
    p.add_argument("--input_size", type=int, default=d.input_size)
    p.add_argument("--vocab_size", type=int, default=d.vocab_size)
    p.add_argument("--d_model", type=int, default=d.d_model)
    p.add_argument("--n_heads", type=int, default=d.n_heads)
    p.add_argument("--num_blocks", type=int, default=d.num_blocks)
    p.add_argument("--d_ff", type=int, default=d.d_ff)
    p.add_argument("--activation", type=str, default=d.activation,
                   choices=["sigmoid", "relu", "tanh", "gelu"])
    p.add_argument("--param_dtype", type=str, default=d.param_dtype)
    p.add_argument("--compute_dtype", type=str, default=d.compute_dtype)
    p.add_argument("--num_experts", type=int, default=d.num_experts)
    p.add_argument("--fused_ln", action="store_true",
                   help="run every LayerNorm (ln1, ln2 with the fused "
                        "residual add, lnf) through the fused CUDA "
                        "kernels")
    p.add_argument("--fp8_ffn", action="store_true",
                   help="run the FFN on fp8-e4m3-rounded operands "
                        "(pow2 scales) through the grouped-FFN CUDA "
                        "kernel")
    p.add_argument("--checkpoint_dir", type=str, default=d.checkpoint_dir)
    p.add_argument("--serve_port", type=int, default=d.serve_port)
    p.add_argument("--decode_page_size", type=int,
                   default=d.decode_page_size)
    p.add_argument("--decode_pages", type=_pages, default=d.decode_pages)
    p.add_argument("--decode_max_batch", type=int,
                   default=d.decode_max_batch)
    p.add_argument("--kv_quant", type=str, default=d.kv_quant,
                   choices=["", "int8"])
    p.add_argument("--deadline_ms", type=float, default=d.deadline_ms)
    p.add_argument("--max_queue", type=int, default=d.max_queue)
    p.add_argument("--brownout", type=str, default=d.brownout)
    p.add_argument("--engine_retries", type=int, default=d.engine_retries)
    p.add_argument("--trace_spans", action="store_true")
    p.add_argument("--slo", type=str, default=d.slo)
    p.add_argument("--replicas", type=int, default=d.replicas)
    p.add_argument("--replay", type=str, default=d.replay)
    p.add_argument("--device", type=str, default=d.device,
                   choices=["cuda", "cpu"],
                   help="where the engine runs (default: the card)")
    return p


def validate_serving_config(cfg: Config) -> None:
    """Value checks of the serving flags (raised before any model is
    built), plus the ``--brownout`` DSL parse."""
    if cfg.deadline_ms < 0:
        raise ValueError(f"deadline_ms={cfg.deadline_ms} must be >= 0")
    if cfg.max_queue < 0:
        raise ValueError(f"max_queue={cfg.max_queue} must be >= 0")
    if cfg.engine_retries < 0:
        raise ValueError(
            f"engine_retries={cfg.engine_retries} must be >= 0")
    if cfg.replicas < 1:
        raise ValueError(f"replicas={cfg.replicas} must be >= 1")
    from .serving.admission import parse_brownout

    parse_brownout(cfg.brownout)


def parse_config(argv: Sequence[str] | None = None) -> Config:
    return Config(**vars(build_parser().parse_args(argv)))
