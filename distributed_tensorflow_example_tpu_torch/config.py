"""Flags of the port's front doors: the serving CLI and the trainer.

The serving and training subsets of the JAX package's ``config.py``, with
the same flag names and defaults, so one command line drives either
package.  ``build_parser`` is ``serving/cli.py``'s: flags of serving
features the port does not have yet are still parsed, and the CLI
refuses them with a message naming ROADMAP.md instead of ignoring them.
``build_train_parser`` is ``main.py``'s: it knows the ported training
flags only (the MLP's and the single-device transformer's, MoE and
``--fp8_ffn`` included), and refuses every other flag of the JAX trainer
(exit 2, naming ROADMAP.md) rather than ignore it: expert, sequence,
tensor and pipeline parallelism (``--expert_parallel``,
``--sequence_parallel``, ``--sp_impl``, ``--model_parallel``,
``--pipeline_parallel``) among them.  ``--device`` is the port's
own: the card (``cuda``) unless ``cpu`` is asked for.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence, Tuple


class Unported(ValueError):
    """A flag, value or mode of the JAX package that the port does not
    have yet; the message names ROADMAP.md.  The CLIs exit 2 on it."""


@dataclasses.dataclass(frozen=True)
class Config:
    seed: int = 1
    # ---- model ----
    model: str = "mlp"              # the serving CLI needs transformer
    objective: str = "classify"     # ... and lm
    input_size: int = 784           # = seq_len for the lm objective
    vocab_size: int = 256
    seq_len: int = 28               # classify: input viewed as tokens
    d_model: int = 128
    n_heads: int = 4
    num_blocks: int = 2
    d_ff: int = 256
    activation: str = "sigmoid"     # sigmoid serves as gelu (JAX CLI rule)
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    num_experts: int = 0            # > 0: MoE FFN (decode and prefill
                                    # route it by dense dispatch)
    moe_topk: int = 1               # experts per token (1 = Switch)
    moe_dispatch: str = "dense"     # dense (exact) | alltoall (sparse)
    capacity_factor: float = 1.25   # alltoall: C = ceil(cf * T * k / E)
    moe_aux_weight: float = 0.0     # weight of the balance loss
    grouped_moe: bool = False       # sparse expert FFN through B8
    attention: str = "dense"        # dense | flash; --pallas also
                                    # selects flash for the transformer
    causal: bool = False            # causal mask (lm is always causal)
    dropout_rate: float = 0.0       # transformer training-only dropout
    remat: bool = False             # recompute the forward in backward
    sample_after: int = 0           # lm: generate N samples after training
    sample_temperature: float = 1.0 # 0 = greedy
    fused_ln: bool = False          # LayerNorms through the fused kernels
    fp8_ffn: bool = False           # FFN on fp8-rounded operands
    checkpoint_dir: str = ""
    # ---- serving ----
    serve_port: int = 0
    decode_page_size: int = 16
    decode_pages: int = 0
    decode_max_batch: int = 8
    kv_quant: str = ""              # "" | int8: the paged KV pools
    deadline_ms: float = 0.0
    max_queue: int = 0
    brownout: str = ""
    engine_retries: int = 0
    trace_spans: bool = False       # request spans under logs_path
    slo: str = ""                   # the SLO DSL; "" = the defaults
    span_rotate_mb: float = 0.0     # --trace_spans: rotate past this
    span_keep: int = 3              # --trace_spans: rotated segments
    replicas: int = 1               # > 1: a fleet behind the router
    fleet_retries: int = 2          # --replicas fleet: failovers
    breaker: str = ""               # --replicas fleet: circuit breaker
    status_cache_s: float = 15.0    # status server's response cache TTL
    # not ported yet: the serving CLI refuses these when set
    outer_quant: str = ""           # multi-site outer sync compression
    replay: str = ""
    replay_speed: float = 1.0       # --replay's time compression
    # ---- training (main.py -> train/loop.run) ----
    job_name: str = ""              # "", "ps" or "worker"; ps is absorbed
    task_index: int = 0             # the process rank
    coordinator_address: str = ""   # host:port of rank 0; "" = one process
    num_processes: int = 1
    batch_size: int = 100           # global batch size
    learning_rate: float = 0.0005
    training_epochs: int = 20
    logs_path: str = "/tmp/mnist/1"
    frequency: int = 100            # steps between throughput prints
    num_classes: int = 10
    hidden_sizes: Tuple[int, ...] = (100,)
    naive_ce: bool = False
    label_smoothing: float = 0.0
    optimizer: str = "sgd"
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    schedule_steps: int = 0
    lr_min_factor: float = 0.0
    weight_decay: float = 0.0
    grad_clip: float = 0.0
    grad_accum: int = 1
    momentum: float = 0.9
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    adam_moments_dtype: str = "float32"
    grad_reduce: str = "mean"
    pallas: bool = False            # MLP forward through the B1 kernel;
                                    # flash attention for the transformer
    data_dir: str = "MNIST_data"
    dataset: str = "auto"
    synthetic_train_size: int = 55000
    synthetic_test_size: int = 10000
    shard_data: bool = True
    summaries: bool = True
    summaries_all_hosts: bool = False
    eval_all_hosts: bool = False
    checkpoint_every: int = 0       # steps; 0 = only at exit
    keep_checkpoints: int = 0
    eval_batch_size: int = 2000
    fast_loop: bool = True          # the device-resident epoch
                                    # (parallel/epoch.py) where the gate
                                    # allows; False: the host-fed loop
    device_prefetch: bool = False   # host path: commit upcoming batches
                                    # from pinned buffers on a copy
                                    # stream ahead of their steps
                                    # (data/prefetch.DevicePrefetcher);
                                    # bit-exact with the blocking copy
    prefetch_depth: int = 0         # device-prefetch lookahead in
                                    # batches; 0 = the default for the
                                    # device (1 on the CPU, 8 on the card)
    dispatch_depth: int = 0         # host path: steps in flight on the
                                    # card before the host waits on the
                                    # oldest; 0 = the default for the
                                    # device (1 on the CPU, 32 on the card)
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
    """The serving CLI's flags, the JAX ``dtx-serve`` names and
    defaults.  ``--attention`` and ``--pallas`` only set the spec's
    attention field and change nothing the server computes: the JAX
    serving path runs its prefill and decode dense whatever that field
    says, and so does the port.  They are kept so that a JAX serving
    command line parses unchanged."""
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
    p.add_argument("--num_classes", type=int, default=d.num_classes)
    p.add_argument("--num_experts", type=int, default=d.num_experts,
                   help="the FFN becomes a top-k MoE with this many "
                        "experts; the prefill and the decode route it "
                        "by exact dense dispatch, as in the JAX package")
    p.add_argument("--moe_topk", type=int, default=d.moe_topk,
                   help="experts per token (1 = Switch; 2 = GShard "
                        "top-2, gates renormalized)")
    p.add_argument("--moe_dispatch", type=str, default=d.moe_dispatch,
                   choices=["dense", "alltoall"],
                   help="the spec's MoE routing (serving routes dense "
                        "whatever it says)")
    p.add_argument("--capacity_factor", type=float,
                   default=d.capacity_factor)
    p.add_argument("--moe_aux_weight", type=float, default=d.moe_aux_weight)
    p.add_argument("--grouped_moe", action="store_true")
    p.add_argument("--attention", type=str, default=d.attention,
                   choices=["dense", "flash"],
                   help="the spec's attention backend (the prefill and "
                        "the decode run dense whatever it says, as in "
                        "the JAX package)")
    p.add_argument("--pallas", action="store_true",
                   help="select flash attention (the JAX CLI's rule)")
    p.add_argument("--fused_ln", action="store_true",
                   help="run every LayerNorm (ln1, ln2 with the fused "
                        "residual add, lnf) through the fused CUDA "
                        "kernels")
    p.add_argument("--fp8_ffn", action="store_true",
                   help="run the FFN on fp8-e4m3-rounded operands "
                        "(pow2 scales) through the grouped-FFN CUDA "
                        "kernel")
    p.add_argument("--checkpoint_dir", type=str, default=d.checkpoint_dir)
    p.add_argument("--logs_path", type=str, default=d.logs_path,
                   help="where --trace_spans writes spans.<proc>.jsonl")
    p.add_argument("--serve_port", type=int, default=d.serve_port)
    p.add_argument("--decode_page_size", type=_depth,
                   default=d.decode_page_size)
    p.add_argument("--decode_pages", type=_pages, default=d.decode_pages)
    p.add_argument("--decode_max_batch", type=_depth,
                   default=d.decode_max_batch)
    p.add_argument("--kv_quant", type=str, default=d.kv_quant,
                   choices=["", "int8"],
                   help="paged KV pools as int8 with a per-row, per-head "
                        "f32 scale plane (about half the bytes of bf16)")
    p.add_argument("--outer_quant", type=str, default=d.outer_quant,
                   choices=["", "int8"])
    p.add_argument("--deadline_ms", type=float, default=d.deadline_ms)
    p.add_argument("--max_queue", type=int, default=d.max_queue)
    p.add_argument("--brownout", type=str, default=d.brownout)
    p.add_argument("--engine_retries", type=int, default=d.engine_retries)
    p.add_argument("--trace_spans", action="store_true",
                   help="record request-lifecycle spans to "
                        "<logs_path>/spans.<proc>.jsonl, feeding /trace, "
                        "/slo, /explain and the brownout's burn rate")
    p.add_argument("--slo", type=str, default=d.slo,
                   help="SLO specs for /slo and the brownout: "
                        "comma-separated NAME<=VALUE with NAME one of "
                        "ttft_p99_ms / latency_p99_ms / error_rate "
                        "(empty = the defaults)")
    p.add_argument("--replicas", type=int, default=d.replicas,
                   help="> 1 runs N engines behind the router (least "
                        "loaded over health, per-replica circuit "
                        "breakers, failover); spans of replica i under "
                        "<logs_path>/replica<i>, the router's under "
                        "<logs_path>/router")
    p.add_argument("--replay", type=str, default=d.replay)
    p.add_argument("--replay_speed", type=float, default=d.replay_speed)
    p.add_argument("--fleet_retries", type=int, default=d.fleet_retries,
                   help="--replicas fleet: the other replicas a request "
                        "may fail over to after a typed failure")
    p.add_argument("--breaker", type=str, default=d.breaker,
                   help="--replicas fleet: the per-replica circuit "
                        "breaker, empty or 'on' for the defaults, else "
                        "key=value over failures/base/cap/jitter/floor/"
                        "seed")
    p.add_argument("--span_rotate_mb", type=float,
                   default=d.span_rotate_mb,
                   help="rotate each spans.<proc>.jsonl before it "
                        "exceeds this many MB (0 = never)")
    p.add_argument("--span_keep", type=int, default=d.span_keep,
                   help="rotated span segments kept per process")
    p.add_argument("--status_cache_s", type=float,
                   default=d.status_cache_s,
                   help="the status server's /report, /fleet and "
                        "/explain cache lifetime (0 = recompute on "
                        "every request)")
    p.add_argument("--device", type=str, default=d.device,
                   choices=["cuda", "cpu"],
                   help="where the engine runs (default: the card)")
    return p


def validate_quant_config(cfg: Config) -> None:
    """The ``--kv_quant`` and ``--fp8_ffn`` legs of the JAX package's
    quantization matrix, raised before any model is built:
    ``kv_quant`` reshapes the paged serving cache, which decodes the lm
    transformer only; ``fp8_ffn`` rounds the transformer FFN's operands,
    and a dense-dispatch MoE never reaches the grouped expert kernel
    the fp8 path rides.  (``--outer_quant`` is refused by the serving
    CLI before this runs: the multi-site outer sync is not ported.)"""
    if cfg.kv_quant not in ("", "int8"):
        raise ValueError(f"kv_quant={cfg.kv_quant!r}: expected '' or "
                         f"'int8'")
    if cfg.kv_quant:
        if cfg.model != "transformer" or cfg.objective != "lm":
            raise ValueError(
                "--kv_quant quantizes the paged serving KV cache, which "
                "decodes the lm transformer only: it needs "
                "--model=transformer --objective=lm")
    if cfg.fp8_ffn:
        if cfg.model != "transformer":
            raise ValueError(
                "--fp8_ffn rounds the transformer FFN matmul "
                "operands; the MLP family has no FFN blocks "
                "(--model=transformer)")
        if cfg.num_experts and cfg.moe_dispatch != "alltoall":
            raise ValueError(
                "--fp8_ffn quantizes the MoE expert FFN through the "
                "sparse grouped kernel; use --moe_dispatch=alltoall "
                "(dense dispatch computes every expert on every "
                "token and never reaches it)")


def validate_serving_config(cfg: Config) -> None:
    """Value checks of the serving flags, raised before any model is
    built (the JAX package's checks and messages), plus the
    ``--brownout`` and ``--breaker`` DSL parses."""
    if cfg.deadline_ms < 0:
        raise ValueError(
            f"deadline_ms={cfg.deadline_ms} must be >= 0 (0 = no "
            f"default deadline)")
    if cfg.max_queue < 0:
        raise ValueError(
            f"max_queue={cfg.max_queue} must be >= 0 (0 = unbounded)")
    if cfg.engine_retries < 0:
        raise ValueError(
            f"engine_retries={cfg.engine_retries} must be >= 0 (0 = "
            f"fail-closed, no supervision)")
    if cfg.span_rotate_mb < 0:
        raise ValueError(
            f"span_rotate_mb={cfg.span_rotate_mb} must be >= 0 (0 = "
            f"never rotate)")
    if cfg.status_cache_s < 0:
        raise ValueError(
            f"status_cache_s={cfg.status_cache_s} must be >= 0 (0 = "
            f"recompute on every request)")
    if cfg.span_keep < 1:
        raise ValueError(
            f"span_keep={cfg.span_keep} must be >= 1 (at least one "
            f"rotated segment is retained while rotation is on)")
    if cfg.replicas < 1:
        raise ValueError(
            f"replicas={cfg.replicas} must be >= 1 (1 = single-"
            f"engine front door, > 1 = fleet behind the router)")
    if cfg.fleet_retries < 0:
        raise ValueError(
            f"fleet_retries={cfg.fleet_retries} must be >= 0 (0 = "
            f"no cross-replica failover)")
    if cfg.replay_speed <= 0:
        raise ValueError(
            f"replay_speed={cfg.replay_speed} must be > 0 (1.0 = "
            f"recorded pace, 2.0 = twice as fast)")
    from .serving.admission import parse_brownout
    from .serving.health import parse_breaker

    parse_brownout(cfg.brownout)
    parse_breaker(cfg.breaker)


def parse_config(argv: Sequence[str] | None = None) -> Config:
    return Config(**vars(build_parser().parse_args(argv)))


def _parse_hidden(s: str) -> Tuple[int, ...]:
    return tuple(int(x) for x in s.replace(",", " ").split())


def _depth(s: str) -> int:
    """Queue/lookahead depth flag value: >= 1 (the device's default is
    selected by NOT passing the flag, never by 0)."""
    v = int(s)
    if v < 1:
        raise argparse.ArgumentTypeError(
            f"depth {v} must be >= 1 (omit the flag for the device's "
            f"default)")
    return v


def build_train_parser() -> argparse.ArgumentParser:
    """The JAX trainer's flags that the port has, with its defaults."""
    p = argparse.ArgumentParser(
        prog="distributed_tensorflow_example_tpu_torch.main",
        description="Train the reference MNIST MLP, or the transformer, "
                    "with the PyTorch port (on the card unless --device "
                    "cpu).  Flags of the JAX trainer that are not ported "
                    "exit 2 (ROADMAP.md).")
    d = Config()
    p.add_argument("--job_name", type=str, default=d.job_name,
                   help="Either 'ps' or 'worker' (reference parity; there "
                        "is no ps role — 'ps' trains as a worker)")
    p.add_argument("--task_index", type=int, default=d.task_index,
                   help="index of this process (its rank)")
    p.add_argument("--coordinator_address", type=str,
                   default=d.coordinator_address,
                   help="host:port of rank 0 (torch.distributed TCP init)")
    p.add_argument("--num_processes", type=int, default=d.num_processes)
    p.add_argument("--batch_size", type=int, default=d.batch_size)
    p.add_argument("--learning_rate", type=float, default=d.learning_rate)
    p.add_argument("--training_epochs", type=int, default=d.training_epochs)
    p.add_argument("--logs_path", type=str, default=d.logs_path)
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--frequency", type=int, default=d.frequency)
    p.add_argument("--model", type=str, default=d.model,
                   choices=["mlp", "transformer"])
    p.add_argument("--input_size", type=int, default=d.input_size)
    p.add_argument("--num_classes", type=int, default=d.num_classes)
    p.add_argument("--objective", type=str, default=d.objective,
                   choices=["classify", "lm"],
                   help="transformer: labeled classification or "
                        "autoregressive next-token prediction over the "
                        "discretized inputs (seq_len = input_size, "
                        "causal)")
    p.add_argument("--vocab_size", type=int, default=d.vocab_size)
    p.add_argument("--seq_len", type=int, default=d.seq_len)
    p.add_argument("--d_model", type=int, default=d.d_model)
    p.add_argument("--n_heads", type=int, default=d.n_heads)
    p.add_argument("--num_blocks", type=int, default=d.num_blocks)
    p.add_argument("--d_ff", type=int, default=d.d_ff)
    p.add_argument("--attention", type=str, default=d.attention,
                   choices=["dense", "flash"],
                   help="transformer attention: dense, or the flash CUDA "
                        "kernels (--pallas selects them too)")
    p.add_argument("--causal", action="store_true")
    p.add_argument("--num_experts", type=int, default=d.num_experts,
                   help="transformer FFN becomes a top-k MoE with this "
                        "many experts (0 = dense FFN)")
    p.add_argument("--moe_topk", type=int, default=d.moe_topk,
                   help="experts per token (1 = Switch; 2 = GShard "
                        "top-2, gates renormalized)")
    p.add_argument("--moe_dispatch", type=str, default=d.moe_dispatch,
                   choices=["dense", "alltoall"],
                   help="MoE token routing: exact dense dispatch vs "
                        "capacity-limited sparse dispatch")
    p.add_argument("--capacity_factor", type=float,
                   default=d.capacity_factor,
                   help="alltoall dispatch: per-expert buffer = "
                        "ceil(cf * tokens * k / E)")
    p.add_argument("--moe_aux_weight", type=float, default=d.moe_aux_weight,
                   help="weight of the Switch load-balance auxiliary "
                        "loss (0 = off)")
    p.add_argument("--grouped_moe", action="store_true",
                   help="alltoall dispatch: run the expert FFN through "
                        "the grouped-FFN CUDA kernel (forward and its "
                        "training form)")
    p.add_argument("--fp8_ffn", action="store_true",
                   help="transformer: run the FFN matmuls (dense W1/W2 "
                        "and the sparse expert FFN) on fp8-e4m3-rounded "
                        "operands with pow2 scales through the "
                        "grouped-FFN CUDA kernel, straight-through "
                        "gradients to the master weights (MoE needs "
                        "--moe_dispatch=alltoall)")
    p.add_argument("--fused_ln", action="store_true",
                   help="transformer: every LayerNorm (ln1, ln2 with the "
                        "residual add, lnf) through the fused CUDA "
                        "kernels, forward and backward")
    p.add_argument("--dropout_rate", type=float, default=d.dropout_rate,
                   help="transformer training-only dropout (embedding + "
                        "per-block residual branches)")
    p.add_argument("--remat", action="store_true",
                   help="recompute the forward's activations in the "
                        "backward instead of keeping them")
    p.add_argument("--sample_after", type=int, default=d.sample_after,
                   help="lm only: generate N samples after training "
                        "(saved to logs_path/samples.npz)")
    p.add_argument("--sample_temperature", type=float,
                   default=d.sample_temperature)
    p.add_argument("--hidden_sizes", type=_parse_hidden,
                   default=d.hidden_sizes, metavar="H1,H2,...",
                   help="e.g. 100 or 256,128")
    p.add_argument("--activation", type=str, default=d.activation,
                   choices=["sigmoid", "relu", "tanh", "gelu"])
    p.add_argument("--param_dtype", type=str, default=d.param_dtype)
    p.add_argument("--compute_dtype", type=str, default=d.compute_dtype)
    p.add_argument("--naive_ce", action="store_true")
    p.add_argument("--label_smoothing", type=float,
                   default=d.label_smoothing)
    p.add_argument("--optimizer", type=str, default=d.optimizer,
                   choices=["sgd", "momentum", "adam"])
    p.add_argument("--lr_schedule", type=str, default=d.lr_schedule,
                   choices=["constant", "cosine", "linear"])
    p.add_argument("--warmup_steps", type=int, default=d.warmup_steps)
    p.add_argument("--schedule_steps", type=int, default=d.schedule_steps)
    p.add_argument("--lr_min_factor", type=float, default=d.lr_min_factor)
    p.add_argument("--weight_decay", type=float, default=d.weight_decay)
    p.add_argument("--grad_clip", type=float, default=d.grad_clip)
    p.add_argument("--grad_accum", type=int, default=d.grad_accum)
    p.add_argument("--momentum", type=float, default=d.momentum)
    p.add_argument("--adam_b1", type=float, default=d.adam_b1)
    p.add_argument("--adam_b2", type=float, default=d.adam_b2)
    p.add_argument("--adam_eps", type=float, default=d.adam_eps)
    p.add_argument("--adam_moments_dtype", type=str,
                   default=d.adam_moments_dtype,
                   choices=["float32", "bfloat16"])
    p.add_argument("--grad_reduce", type=str, default=d.grad_reduce,
                   choices=["mean", "sum"])
    p.add_argument("--pallas", action="store_true",
                   help="run the MLP forward (train and eval) through the "
                        "fused CUDA kernel (sigmoid/tanh/relu); for the "
                        "transformer, select flash attention")
    p.add_argument("--data_dir", type=str, default=d.data_dir)
    p.add_argument("--dataset", type=str, default=d.dataset,
                   choices=["auto", "mnist", "synthetic"])
    p.add_argument("--synthetic_train_size", type=int,
                   default=d.synthetic_train_size)
    p.add_argument("--synthetic_test_size", type=int,
                   default=d.synthetic_test_size)
    p.add_argument("--no_shard_data", dest="shard_data",
                   action="store_false")
    p.add_argument("--device_prefetch", action="store_true",
                   help="host path: commit upcoming batches from pinned "
                        "host buffers on a copy stream ahead of "
                        "consumption, so the copy of batch N+1 overlaps "
                        "the step of batch N (bit-exact with the "
                        "blocking copy; the default fast path keeps the "
                        "dataset on the card and ignores this)")
    p.add_argument("--prefetch_depth", type=_depth, default=d.prefetch_depth,
                   help="device-prefetch lookahead in batches (>= 1; "
                        "omit for the device's default: 1 on the CPU, 8 "
                        "on the card)")
    p.add_argument("--dispatch_depth", type=_depth, default=d.dispatch_depth,
                   help="max steps in flight on the host path (>= 1; "
                        "omit for the device's default: 1 on the CPU, "
                        "32 on the card)")
    p.add_argument("--no_summaries", dest="summaries", action="store_false")
    p.add_argument("--summaries_all_hosts", action="store_true")
    p.add_argument("--eval_all_hosts", action="store_true")
    p.add_argument("--checkpoint_dir", type=str, default=d.checkpoint_dir)
    p.add_argument("--checkpoint_every", type=int,
                   default=d.checkpoint_every)
    p.add_argument("--keep_checkpoints", type=int,
                   default=d.keep_checkpoints)
    p.add_argument("--eval_batch_size", type=int, default=d.eval_batch_size)
    p.add_argument("--no_fast_loop", dest="fast_loop", action="store_false",
                   help="feed one batch per step from the host instead "
                        "of the default device-resident epoch (the whole "
                        "split on the card, shuffled there each epoch; "
                        "the MLP's step replayed as a CUDA graph)")
    p.add_argument("--device", type=str, default=d.device,
                   choices=["cuda", "cpu"],
                   help="where training runs (default: the card)")
    return p


def parse_train_config(argv: Sequence[str] | None = None) -> Config:
    """The trainer's flags; any flag the port does not have exits 2 with
    a message naming ROADMAP.md."""
    p = build_train_parser()
    ns, rest = p.parse_known_args(argv)
    if rest:
        flags = sorted({a.split("=", 1)[0] for a in rest
                        if a.startswith("-")}) or rest
        p.error(f"{', '.join(flags)}: not ported to the PyTorch trainer "
                f"yet (see ROADMAP.md Queue A)")
    return Config(**vars(ns))


def validate_train_config(cfg: Config) -> None:
    """Value checks of the ported training flags; ``Unported`` for a
    mode of the JAX trainer the port does not have."""
    if cfg.batch_size < 1 or cfg.training_epochs < 0 or cfg.frequency < 1:
        raise ValueError("batch_size and frequency must be >= 1, "
                         "training_epochs >= 0")
    if not 0.0 <= cfg.label_smoothing < 1.0:
        raise ValueError(
            f"label_smoothing={cfg.label_smoothing} must be in [0, 1)")
    if cfg.weight_decay < 0 or cfg.grad_clip < 0:
        raise ValueError("weight_decay and grad_clip must be >= 0")
    if cfg.grad_accum < 1:
        raise ValueError(f"grad_accum={cfg.grad_accum} must be >= 1")
    if cfg.keep_checkpoints < 0:
        raise ValueError(
            f"keep_checkpoints={cfg.keep_checkpoints} must be >= 0")
    if cfg.dispatch_depth < 0:
        raise ValueError(f"dispatch_depth={cfg.dispatch_depth} must be "
                         f">= 0 (0 = the device's default)")
    if cfg.prefetch_depth < 0:
        raise ValueError(f"prefetch_depth={cfg.prefetch_depth} must be "
                         f">= 0 (0 = the device's default)")
    if cfg.eval_batch_size < 1:
        raise ValueError(
            f"eval_batch_size={cfg.eval_batch_size} must be >= 1")
    if not 0.0 <= cfg.dropout_rate < 1.0:
        raise ValueError(
            f"dropout_rate={cfg.dropout_rate} must be in [0, 1)")
    if cfg.sample_after < 0:
        raise ValueError(f"sample_after={cfg.sample_after} must be >= 0")
    if cfg.num_processes < 1 or not 0 <= cfg.task_index < cfg.num_processes:
        raise ValueError(f"task_index={cfg.task_index} must be in "
                         f"[0, num_processes={cfg.num_processes})")
    if cfg.num_experts < 0:
        raise ValueError(f"num_experts={cfg.num_experts} must be >= 0")
    if cfg.num_experts and cfg.model != "transformer":
        raise ValueError("--num_experts applies to --model=transformer only")
    if cfg.num_experts and cfg.capacity_factor <= 0:
        raise ValueError(
            f"capacity_factor={cfg.capacity_factor} must be > 0")
    if cfg.num_experts and not 1 <= cfg.moe_topk <= cfg.num_experts:
        raise ValueError(
            f"moe_topk={cfg.moe_topk} must be in [1, num_experts="
            f"{cfg.num_experts}]")
    if cfg.moe_aux_weight and not cfg.num_experts:
        raise ValueError("--moe_aux_weight requires --num_experts > 0")
    if cfg.moe_aux_weight < 0:
        raise ValueError(
            f"moe_aux_weight={cfg.moe_aux_weight} must be >= 0")
    if cfg.fp8_ffn:
        if cfg.model != "transformer":
            raise ValueError(
                "--fp8_ffn rounds the transformer FFN matmul "
                "operands; the MLP family has no FFN blocks "
                "(--model=transformer)")
        if cfg.num_experts and cfg.moe_dispatch != "alltoall":
            raise ValueError(
                "--fp8_ffn quantizes the MoE expert FFN through the "
                "sparse grouped kernel; use --moe_dispatch=alltoall "
                "(dense dispatch computes every expert on every "
                "token and never reaches it)")
