"""Flags of the port's front doors: the serving CLI and the trainer.

The serving and training subsets of the JAX package's ``config.py``, with
the same flag names and defaults, so one command line drives either
package.  ``build_parser`` is ``serving/cli.py``'s: flags of serving
features the port does not have yet are still parsed, and the CLI
refuses them with a message naming ROADMAP.md instead of ignoring them.
``build_train_parser`` is ``main.py``'s: it knows the ported training
flags only (the MLP's and the single-device transformer's, MoE and
``--fp8_ffn`` included; the classic and sharded checkpoints, ``--resume``
and the resilience store's ``--ckpt_every``; the ``ckpt`` phase spans of
``--trace_spans``; the monitoring flags ``--metrics``, ``--flight``,
``--on_anomaly``, ``--status_port``, ``--histograms``, ``--profile*``,
``--early_stop_patience`` and ``--debug_nans``; ``--profile_port`` is
refused for good; the data-parallel strategies ``--data_parallel``,
``--microbatches``, ``--sync_period``, ``--zero_opt`` and ``--fsdp``,
tensor parallelism ``--model_parallel``, with JAX's refusals of
their combinations, ``validate_strategy_config``; multi-site local SGD
``--sites``, ``--inner_steps``, ``--outer_optimizer``, ``--outer_lr``,
``--outer_momentum`` and ``--outer_quant``, with JAX's
``validate_local_sgd_config``; sequence parallelism
``--sequence_parallel`` and ``--sp_impl``, with JAX's refusals
(``validate_sequence_config``); expert parallelism ``--expert_parallel``,
with JAX's (``validate_expert_config``); pipeline parallelism
``--pipeline_parallel``, ``--virtual_stages`` and ``--pp_schedule``, with
JAX's ``validate_pipeline_config``; ``--compilation_cache`` is accepted
and explained away), and refuses every other flag of the JAX trainer
(exit 2, naming ROADMAP.md) rather than ignore it: ``--mnist_mirrors``.
Both parsers take the multi-site family, as JAX's shared parser does.
``--device`` is the port's own: the card (``cuda``) unless ``cpu`` is
asked for.
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
    trace_spans: bool = False       # request spans (serving) or the
                                    # ckpt phase spans (training) under
                                    # logs_path
    slo: str = ""                   # the SLO DSL; "" = the defaults
    span_rotate_mb: float = 0.0     # --trace_spans: rotate past this
    span_keep: int = 3              # --trace_spans: rotated segments
    replicas: int = 1               # > 1: a fleet behind the router
    fleet_retries: int = 2          # --replicas fleet: failovers
    breaker: str = ""               # --replicas fleet: circuit breaker
    status_cache_s: float = 15.0    # status server's response cache TTL
    replay: str = ""                # a workload file to replay
    replay_speed: float = 1.0       # --replay's time compression
    # ---- multi-site local SGD (parallel/local_sgd.py) ----
    sites: int = 1                  # > 1: sites sync-DP groups over a
                                    # ('site', 'data') layout, one outer
                                    # pseudo-gradient mean a round
    inner_steps: int = 1            # H: local steps a round; each round
                                    # takes one --batch_size batch in H
                                    # chunks
    outer_optimizer: str = "nesterov"  # nesterov | sgd (momentum 0)
    outer_lr: float = 0.7           # DiLoCo's recipe value
    outer_momentum: float = 0.9
    outer_quant: str = ""           # "" | int8: the outer sync compressed
                                    # with per-site error feedback
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
    # ---- data and tensor parallelism (parallel/): rank r plays device
    # r of the JAX package's one-process ('data', 'model') mesh ----
    data_parallel: int = -1         # -1: world / model_parallel
    model_parallel: int = 1         # Megatron-style TP over the hidden dim
    pipeline_parallel: int = 1      # transformer only: pipeline stages
                                    # over a ('data', 'stage') layout
    microbatches: int = 4           # GPipe microbatches (pipeline only)
    virtual_stages: int = 1         # > 1: Megatron interleaved virtual
                                    # stages (each stage v chunks of
                                    # num_blocks / (p v) blocks)
    pp_schedule: str = "gpipe"      # gpipe (the forward's ticks, then
                                    # their transpose in reverse) | 1f1b
                                    # (fused ticks; the stash
                                    # M-independent)
    sequence_parallel: int = 1      # transformer only: the token axis
                                    # split over a ('data', 'seq') layout
    sp_impl: str = "ring"           # ring (k/v blocks rotate) | ulysses
                                    # (head <-> seq all-to-all)
    expert_parallel: int = 1        # MoE transformer only: the expert
                                    # stacks split over a ('data',
                                    # 'expert') layout
    sync_period: int = 1            # 1 = all-reduce every step; K > 1 =
                                    # local SGD, the async analog: each
                                    # rank's replica averaged every K
    zero_opt: bool = False          # ZeRO-1: optimizer slots 1/dp a rank
    fsdp: bool = False              # ZeRO-3: params + slots 1/dp a rank
    compilation_cache: str = "auto" # accepted, a no-op (cluster.py)
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
    sharded_checkpoints: bool = False  # per-process shard files + the
                                    # chief's manifest (ckpt-N.shards/)
    async_checkpoints: bool = False # write the shard files from a
                                    # background thread (requires
                                    # --sharded_checkpoints)
    # ---- resilience (resilience/*): write-behind snapshots, SIGTERM
    # snapshots, exact-step auto-resume ----
    ckpt_every: int = 0             # steps between snapshots; 0 = off
    ckpt_keep: int = 0              # newest valid snapshots kept; 0 = all
    resume: str = ""                # "" = fresh; "latest" (bare
                                    # --resume) = newest classic
                                    # checkpoint; "auto" = newest valid
                                    # resilience manifest, exact step
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
    # ---- monitoring (obs/): telemetry rows, forensics, profiling ----
    metrics: bool = False           # one JSON row per --log_every window
                                    # to <logs_path>/metrics.<proc>.jsonl
                                    # (step-time percentiles, the host
                                    # split, examples/s, MFU, memory) +
                                    # heartbeats and the chief's
                                    # straggler events
    log_every: int = 100            # metrics window in steps; also the
                                    # --histograms summary cadence
    flight: bool = False            # flight recorder: the last K step
                                    # records + an env snapshot dumped to
                                    # <logs_path>/flight/<proc>.json on a
                                    # crash, an anomaly or SIGUSR1 (on
                                    # whenever --on_anomaly is set)
    flight_steps: int = 64          # the flight recorder's ring size K
    on_anomaly: str = ""            # "" (off) | halt | dump | skip
                                    # (obs/anomaly.py)
    anomaly_factor: float = 10.0    # loss-EMA watchdog: flag a loss above
                                    # factor * EMA
    status_port: int = 0            # > 0: the chief serves /status,
                                    # /metrics, /report over logs_path
    histograms: bool = False        # grad-norm / param-norm / lr
                                    # summaries every --log_every steps
                                    # (forces the host path)
    profile: bool = False           # whole-run torch.profiler trace
    profile_steps: str = ""         # "START:COUNT": windowed capture
    profile_port: int = 0           # JAX's on-demand profiler server:
                                    # no torch counterpart, refused
    early_stop_patience: int = 0    # > 0: stop after P epochs without a
                                    # better validation accuracy
    debug_nans: bool = False        # host path; FloatingPointError at
                                    # the first non-finite loss or grad
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


def _add_site_flags(p: argparse.ArgumentParser, d: "Config") -> None:
    """The multi-site flags with JAX's names, defaults and help (JAX's
    one parser carries them for both front doors)."""
    p.add_argument("--sites", type=int, default=d.sites,
                   help="multi-site local SGD (DiLoCo-style): train "
                        "N independent sync-DP sites over a "
                        "('site','data') mesh, one outer "
                        "pseudo-gradient psum crossing 'site' per "
                        "--inner_steps local steps (model_parallel=1; "
                        "host loop)")
    p.add_argument("--inner_steps", type=int, default=d.inner_steps,
                   help="H: local optimizer steps per outer sync "
                        "under --sites > 1; one --batch_size batch "
                        "per round, split into H chunks (comm bytes "
                        "drop ~H-fold vs per-step sync DP)")
    p.add_argument("--outer_optimizer", type=str,
                   default=d.outer_optimizer,
                   choices=["nesterov", "sgd"],
                   help="multi-site outer update over pseudo-"
                        "gradients (sgd = momentum 0; outer_lr=1 "
                        "sgd = plain parameter averaging)")
    p.add_argument("--outer_lr", type=float, default=d.outer_lr,
                   help="outer learning rate for --sites > 1 "
                        "(DiLoCo recipe default 0.7)")
    p.add_argument("--outer_momentum", type=float,
                   default=d.outer_momentum,
                   help="outer Nesterov momentum for --sites > 1")
    p.add_argument("--outer_quant", type=str, default=d.outer_quant,
                   choices=["", "int8"],
                   help="compress the multi-site outer pseudo-"
                        "gradient sync to symmetric per-leaf int8 "
                        "with per-site error feedback (~4x fewer "
                        "bytes across 'site' per round; needs "
                        "--sites > 1)")


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
    _add_site_flags(p, d)
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
    p.add_argument("--replay", type=str, default=d.replay,
                   help="serve no HTTP: replay this WORKLOAD json "
                        "(obs/workload.py) open-loop through the engine "
                        "or the --replicas fleet and print the replay "
                        "report (exit 1 when a request wedged)")
    p.add_argument("--replay_speed", type=float, default=d.replay_speed,
                   help="--replay's time compression: arrivals fire at "
                        "arrival_s / speed and relative deadlines scale "
                        "by 1/speed")
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
    the fp8 path rides, and tensor parallelism row-splits the
    contraction its per-tensor scales cover; ``outer_quant`` compresses
    the cross-site outer sync, which needs ``--sites`` > 1 (JAX's
    ``validate_quant_config``, its checks in its order)."""
    if cfg.kv_quant not in ("", "int8"):
        raise ValueError(f"kv_quant={cfg.kv_quant!r}: expected '' or "
                         f"'int8'")
    if cfg.outer_quant not in ("", "int8"):
        raise ValueError(f"outer_quant={cfg.outer_quant!r}: expected "
                         f"'' or 'int8'")
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
        if cfg.model_parallel > 1:
            raise ValueError(
                "--fp8_ffn does not compose with --model_parallel: "
                "tensor parallelism row-splits the FFN contraction "
                "the per-tensor fp8 scales cover")
        if cfg.num_experts and cfg.moe_dispatch != "alltoall":
            raise ValueError(
                "--fp8_ffn quantizes the MoE expert FFN through the "
                "sparse grouped kernel; use --moe_dispatch=alltoall "
                "(dense dispatch computes every expert on every "
                "token and never reaches it)")
    if cfg.outer_quant and cfg.sites <= 1:
        raise ValueError(
            "--outer_quant compresses the cross-site outer "
            "pseudo-gradient sync; it needs --sites > 1")


def validate_span_config(cfg: Config) -> None:
    """The span stream's rotation flags (both CLIs' ``--trace_spans``)."""
    if cfg.span_rotate_mb < 0:
        raise ValueError(
            f"span_rotate_mb={cfg.span_rotate_mb} must be >= 0 (0 = "
            f"never rotate)")
    if cfg.span_keep < 1:
        raise ValueError(
            f"span_keep={cfg.span_keep} must be >= 1 (at least one "
            f"rotated segment is retained while rotation is on)")


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
    validate_span_config(cfg)
    if cfg.status_cache_s < 0:
        raise ValueError(
            f"status_cache_s={cfg.status_cache_s} must be >= 0 (0 = "
            f"recompute on every request)")
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


def _resume_mode(s: str) -> str:
    """--resume value: "latest" (the bare flag) or "auto" (the
    resilience store's exact-step resume); "" is the default passing
    through the converter."""
    if s not in ("", "latest", "auto"):
        raise argparse.ArgumentTypeError(
            f"resume mode {s!r}: expected 'latest' (bare --resume) or "
            f"'auto' (exact-step resilience resume)")
    return s


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
    p.add_argument("--data_parallel", type=int, default=d.data_parallel,
                   help="ranks on the data axis (-1 = the world size "
                        "over --model_parallel; any other value must "
                        "make dp x mp the world size: rank r plays "
                        "device r of the JAX one-process mesh)")
    p.add_argument("--model_parallel", type=int, default=d.model_parallel,
                   help="Megatron tensor parallelism: ranks on the model "
                        "axis (rank r at data index r // mp, model index "
                        "r %% mp)")
    p.add_argument("--pipeline_parallel", type=int,
                   default=d.pipeline_parallel,
                   help="transformer only: GPipe pipeline stages over a "
                        "('data','stage') mesh")
    p.add_argument("--microbatches", type=int, default=d.microbatches,
                   help="GPipe microbatches per local batch")
    p.add_argument("--virtual_stages", type=int, default=d.virtual_stages,
                   help="interleaved virtual stages per pipeline stage "
                        "(>1 shrinks the pipeline bubble ~v-fold; "
                        "composes with both schedules — with "
                        "--pp_schedule=1f1b it runs interleaved-1F1B)")
    p.add_argument("--pp_schedule", type=str, default=d.pp_schedule,
                   choices=["gpipe", "1f1b"],
                   help="pipeline schedule: gpipe (all-forward then "
                        "all-backward) vs 1f1b (fused ticks; live "
                        "microbatch activations cap at min(vM, 2pv-1), "
                        "M-independent; with --virtual_stages>1 the "
                        "interleaved-1F1B schedule with async "
                        "stage-hop overlap)")
    p.add_argument("--sequence_parallel", type=int,
                   default=d.sequence_parallel,
                   help="transformer only: shard the token axis over a "
                        "('data','seq') mesh (--sp_impl selects the "
                        "layout; rank r at data index r // (sp*mp), seq "
                        "index (r // mp) %% sp)")
    p.add_argument("--sp_impl", type=str, default=d.sp_impl,
                   choices=["ring", "ulysses"],
                   help="sequence-parallel attention: the k/v ring "
                        "(send/recv) or the head<->seq all_to_all "
                        "(DeepSpeed-Ulysses style)")
    p.add_argument("--expert_parallel", type=int,
                   default=d.expert_parallel,
                   help="MoE only: shard expert weights+FLOPs over a "
                        "('data','expert') mesh (rank r at data index "
                        "r // (ep*mp), expert index (r // mp) %% ep)")
    p.add_argument("--sync_period", type=int, default=d.sync_period,
                   help="K>1 = the LEGACY local-SGD async analog: "
                        "divergent replicas averaged every K steps "
                        "(each replica's per-update batch is "
                        "batch_size/dp; the reference gave each async "
                        "worker a FULL batch per update — use "
                        "batch_size = dp*100 to match)")
    _add_site_flags(p, d)
    p.add_argument("--fsdp", action="store_true",
                   help="ZeRO-3: shard params+optimizer state 1/dp per "
                        "device")
    p.add_argument("--zero_opt", action="store_true",
                   help="ZeRO-1: shard OPTIMIZER state 1/dp over the "
                        "data axis (params keep their layout)")
    p.add_argument("--compilation_cache", type=str,
                   default=d.compilation_cache,
                   help="accepted and ignored: the port compiles nothing "
                        "at run time (its CUDA kernels are built once "
                        "into build/kernels/), and XLA's persistent "
                        "compile cache has no PyTorch counterpart")
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
                   default=d.keep_checkpoints,
                   help="retain only the N newest checkpoints (0 = all)")
    p.add_argument("--sharded_checkpoints", action="store_true",
                   help="per-process shard files + the chief's manifest "
                        "(ckpt-N.shards/) instead of the single .npz")
    p.add_argument("--async_checkpoints", action="store_true",
                   help="write checkpoint shard files from a "
                        "background thread (requires "
                        "--sharded_checkpoints)")
    p.add_argument("--ckpt_every", type=int, default=d.ckpt_every,
                   help="resilience store: write-behind incremental "
                        "snapshot every N steps (0 = off; takes the "
                        "host path; installs the SIGTERM final-"
                        "snapshot handler)")
    p.add_argument("--ckpt_keep", type=int, default=d.ckpt_keep,
                   help="resilience retention: keep the newest K "
                        "valid snapshots and GC unreferenced objects "
                        "(0 = keep all; requires --ckpt_every)")
    p.add_argument("--resume", nargs="?", const="latest",
                   default=d.resume, type=_resume_mode,
                   help="bare --resume = newest classic checkpoint "
                        "(epoch granularity); --resume=auto = newest "
                        "valid resilience manifest, replayed to the "
                        "exact step (takes the host path)")
    p.add_argument("--trace_spans", action="store_true",
                   help="record a ckpt phase span per checkpoint to "
                        "<logs_path>/spans.<proc>.jsonl, every row "
                        "under one run-level trace id")
    p.add_argument("--span_rotate_mb", type=float,
                   default=d.span_rotate_mb,
                   help="rotate spans.<proc>.jsonl before it exceeds "
                        "this many MB; 0 = never rotate")
    p.add_argument("--span_keep", type=int, default=d.span_keep,
                   help="rotated span segments retained (only with "
                        "--span_rotate_mb)")
    p.add_argument("--eval_batch_size", type=int, default=d.eval_batch_size)
    p.add_argument("--no_fast_loop", dest="fast_loop", action="store_false",
                   help="feed one batch per step from the host instead "
                        "of the default device-resident epoch (the whole "
                        "split on the card, shuffled there each epoch; "
                        "the MLP's step replayed as a CUDA graph)")
    p.add_argument("--metrics", action="store_true",
                   help="write structured telemetry rows (step-time "
                        "percentiles, data-wait/device split, examples/s, "
                        "MFU, memory) to <logs_path>/metrics.<proc>.jsonl "
                        "every --log_every steps (one row an epoch on the "
                        "fast path), plus per-process heartbeat files and "
                        "the chief's straggler events")
    p.add_argument("--log_every", type=int, default=d.log_every,
                   help="metrics window size in steps (also the "
                        "--histograms summary cadence)")
    p.add_argument("--flight", action="store_true",
                   help="crash flight recorder: last --flight_steps "
                        "step records + env snapshot dumped to "
                        "<logs_path>/flight/<proc>.json on crash, "
                        "anomaly or SIGUSR1 (with stack dumps)")
    p.add_argument("--flight_steps", type=int, default=d.flight_steps,
                   help="flight-recorder ring capacity (last K steps)")
    p.add_argument("--on_anomaly", type=str, default=d.on_anomaly,
                   choices=["", "halt", "dump", "skip"],
                   help="in-step anomaly policy: halt (record + stop; "
                        "takes the host path), dump (flight dump + "
                        "continue), skip (the step masks the update on a "
                        "non-finite loss or gradient, on the card and "
                        "inside the CUDA graph; skipped steps "
                        "accounted). Enables the flight recorder and the "
                        "loss-EMA divergence watchdog")
    p.add_argument("--anomaly_factor", type=float, default=d.anomaly_factor,
                   help="divergence watchdog threshold: flag a loss "
                        "above factor * rolling EMA")
    p.add_argument("--status_port", type=int, default=d.status_port,
                   help="serve live run status over HTTP on this port "
                        "(chief only): /status JSON, /metrics "
                        "Prometheus text, /report goodput report")
    p.add_argument("--status_cache_s", type=float,
                   default=d.status_cache_s,
                   help="status-server response cache TTL in seconds "
                        "(0 = recompute on every request)")
    p.add_argument("--histograms", action="store_true",
                   help="emit grad-norm/param-norm histogram and "
                        "learning-rate summaries into the event file "
                        "every --log_every steps (host path; no per-step "
                        "host sync)")
    p.add_argument("--profile", action="store_true",
                   help="whole-run torch.profiler trace (skews perf and "
                        "grows unboundedly; prefer --profile_steps), a "
                        "Chrome trace under <logs_path>/profile/")
    p.add_argument("--profile_steps", type=str, default=d.profile_steps,
                   metavar="START:COUNT",
                   help="windowed torch.profiler capture: trace exactly "
                        "COUNT steps starting at global step START "
                        "(0-based), with record_function and NVTX ranges "
                        "named as the --metrics timing split; a Chrome "
                        "trace under <logs_path>/profile/; replaces "
                        "--profile")
    p.add_argument("--profile_port", type=int, default=d.profile_port,
                   help="refused: JAX's on-demand profiler server has no "
                        "PyTorch counterpart (use --profile_steps)")
    p.add_argument("--early_stop_patience", type=int,
                   default=d.early_stop_patience,
                   help="stop after P epochs without validation "
                        "improvement (0 = off)")
    p.add_argument("--debug_nans", action="store_true",
                   help="take the host path and raise FloatingPointError "
                        "at the first step whose loss or gradients are "
                        "not finite (superseded by --on_anomaly, which "
                        "records forensics context)")
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
    if ns.profile_port:
        p.error(PROFILE_PORT_REFUSED)
    return Config(**vars(ns))


PROFILE_PORT_REFUSED = (
    "--profile_port: JAX's on-demand profiler server has no PyTorch "
    "counterpart and is refused for good (use --profile_steps START:COUNT "
    "for a windowed torch.profiler trace)")


def validate_monitoring_config(cfg: Config) -> None:
    """The monitoring flags' checks, with the JAX trainer's messages."""
    if cfg.log_every < 1:
        raise ValueError(f"log_every={cfg.log_every} must be >= 1")
    if cfg.histograms and not cfg.summaries:
        raise ValueError("--histograms writes histogram summaries "
                         "into the event file; do not combine "
                         "with --no_summaries")
    from .obs import tracer as tracer_lib

    # raises ValueError on a malformed START:COUNT
    window = tracer_lib.parse_profile_steps(cfg.profile_steps)
    if window is not None and cfg.profile:
        raise ValueError("--profile_steps replaces the whole-run "
                         "--profile trace; drop one of the two")
    if cfg.profile_port:
        raise ValueError(PROFILE_PORT_REFUSED)
    if cfg.status_port < 0:
        raise ValueError(f"status_port={cfg.status_port} must be >= 0")
    if cfg.status_cache_s < 0:
        raise ValueError(
            f"status_cache_s={cfg.status_cache_s} must be >= 0 (0 = "
            f"recompute on every request)")
    from .obs.anomaly import POLICIES

    if cfg.on_anomaly not in POLICIES:
        raise ValueError(
            f"on_anomaly={cfg.on_anomaly!r}: expected one of "
            f"{[p for p in POLICIES if p]}")
    if cfg.on_anomaly and cfg.debug_nans:
        raise ValueError("--debug_nans is superseded by --on_anomaly "
                         "(it stops at the first non-finite step with no "
                         "forensics context); drop one of the two")
    if cfg.on_anomaly and cfg.anomaly_factor <= 1.0:
        raise ValueError(
            f"anomaly_factor={cfg.anomaly_factor} must be > 1")
    if cfg.flight_steps < 1:
        raise ValueError(f"flight_steps={cfg.flight_steps} must be >= 1")
    if cfg.early_stop_patience < 0:
        raise ValueError(
            f"early_stop_patience={cfg.early_stop_patience} must be >= 0")


# JAX's refusal of local SGD under tensor parallelism (its local step
# and its whole-run local program raise it)
LOCAL_SGD_TP_REFUSED = (
    "local SGD (--sync_period K>1, the async analog) requires "
    "model_parallel=1 — as does the first-class multi-site "
    "path, --sites with a ('site','data') mesh "
    "(parallel/local_sgd.py)")


def validate_strategy_config(cfg: Config) -> None:
    """The data-parallel strategies' matrix, with the JAX trainer's
    messages: ``--fsdp`` and ``--zero_opt`` run on the synchronous step,
    and the features that ride the synchronous step's outputs
    (``--histograms``, ``--on_anomaly=skip``, ``--grad_accum``,
    ``--dropout_rate``) are refused under ``--fsdp`` or local SGD.
    ``--debug_nans`` reads the synchronous step's non-finite flag, which
    the FSDP and local-SGD steps do not return: ``Unported`` there."""
    local_sgd = cfg.sync_period > 1
    if local_sgd and cfg.model_parallel != 1:
        raise ValueError(LOCAL_SGD_TP_REFUSED)
    if cfg.fsdp and local_sgd:
        raise ValueError("--fsdp requires the synchronous step "
                         "(sync_period=1)")
    if cfg.zero_opt:
        if cfg.fsdp:
            raise ValueError("--zero_opt is redundant under --fsdp "
                             "(ZeRO-3 already shards optimizer state)")
        if local_sgd:
            raise ValueError("--zero_opt requires the synchronous step "
                             "(sync_period=1)")
    if cfg.dropout_rate and local_sgd:
        raise ValueError("--dropout_rate runs on the synchronous "
                         "step (sync_period=1); the local-SGD "
                         "replicas keep their own objectives")
    if cfg.histograms and (cfg.fsdp or local_sgd):
        raise ValueError("--histograms rides the synchronous SPMD "
                         "step's norm outputs (no --fsdp, "
                         "sync_period=1)")
    if cfg.on_anomaly == "skip" and (cfg.fsdp or local_sgd):
        raise ValueError("--on_anomaly=skip rides the synchronous "
                         "step's compiled update mask (no --fsdp, "
                         "sync_period=1); halt/dump work on any path")
    if cfg.grad_accum > 1 and (cfg.fsdp or local_sgd):
        raise ValueError("--grad_accum runs on the synchronous step "
                         "(no --fsdp, sync_period=1)")
    if cfg.debug_nans and (cfg.fsdp or local_sgd):
        raise Unported("--debug_nans under --fsdp or --sync_period > 1: "
                       "the port's check reads the synchronous step's "
                       "non-finite flag (see ROADMAP.md)")


def validate_local_sgd_config(cfg: Config) -> None:
    """The multi-site (``--sites``) matrix, JAX's checks and messages:
    ``sites`` > 1 selects the ('site', 'data') layout of independent
    sync-DP groups, H = ``inner_steps`` local steps a round
    (``parallel/local_sgd.py``).  It composes with data parallelism
    inside each site only (no TP, FSDP, ZeRO-1 or ``--sync_period``),
    runs on the host path, and refuses what rides the synchronous
    step's extra outputs (``--histograms``, ``--on_anomaly=skip``) and
    dropout."""
    if cfg.sites < 1:
        raise ValueError(f"sites={cfg.sites} must be >= 1")
    if cfg.inner_steps < 1:
        raise ValueError(f"inner_steps={cfg.inner_steps} must be >= 1")
    if cfg.outer_optimizer not in ("nesterov", "sgd"):
        raise ValueError(
            f"outer_optimizer={cfg.outer_optimizer!r}: expected "
            f"'nesterov' or 'sgd'")
    if cfg.sites == 1:
        if cfg.inner_steps > 1:
            raise ValueError("--inner_steps > 1 needs --sites > 1 "
                             "(no outer sync to amortize on one site)")
        return
    if cfg.model != "mlp" and cfg.model != "transformer":
        raise ValueError(f"unknown model {cfg.model!r}")
    if cfg.model_parallel > 1:
        raise ValueError("--sites composes with data parallelism "
                         "inside each site only (model_parallel=1)")
    if cfg.sync_period > 1:
        raise ValueError("--sites supersedes the legacy --sync_period "
                         "local-SGD analog; use one of the two "
                         "(--sites N --inner_steps K --outer_optimizer "
                         "sgd --outer_lr 1 reproduces --sync_period K)")
    if (cfg.fsdp or cfg.zero_opt or cfg.pipeline_parallel > 1
            or cfg.sequence_parallel > 1 or cfg.expert_parallel > 1):
        raise ValueError("--sites composes with within-site data "
                         "parallelism only (no fsdp/zero_opt/"
                         "pipeline/sequence/expert parallelism)")
    if cfg.outer_lr <= 0:
        raise ValueError(f"outer_lr={cfg.outer_lr} must be > 0")
    if not 0.0 <= cfg.outer_momentum < 1.0:
        raise ValueError(
            f"outer_momentum={cfg.outer_momentum} must be in [0, 1)")
    if cfg.dropout_rate:
        raise ValueError("--dropout_rate runs on the synchronous step "
                         "(sites=1); the multi-site round keeps its "
                         "own per-site objectives")
    if cfg.histograms:
        raise ValueError("--histograms rides the synchronous step's "
                         "norm outputs (sites=1)")
    if cfg.on_anomaly == "skip":
        raise ValueError("--on_anomaly=skip rides the synchronous "
                         "step's compiled update mask (sites=1); "
                         "halt/dump work on the multi-site path")


def validate_pipeline_config(cfg: Config) -> None:
    """The pipeline-parallelism / schedule matrix of the JAX trainer
    (JAX's ``validate_pipeline_config``, its messages):

    - ``pipeline_parallel`` >= 1; > 1 needs the transformer, divisible
      ``num_blocks``, ``microbatches`` >= 1, and composes with data,
      tensor, sequence and expert parallelism only (no FSDP, no local
      SGD), seq XOR expert;
    - ``pp_schedule`` in {gpipe, 1f1b}; 1f1b needs >= 2 stages and
      composes with DP x PP x TP at any ``virtual_stages`` (no seq or
      expert token sharding, no MoE balance loss, no ``--grad_accum``,
      no ``--remat``: per-slot remat is built in);
    - ``virtual_stages`` >= 1; > 1 (either schedule) needs >= 2 stages,
      ``num_blocks`` divisible over stages x virtual and
      ``microbatches`` divisible by the stage count."""
    if cfg.pipeline_parallel < 1:
        raise ValueError(
            f"pipeline_parallel={cfg.pipeline_parallel} must be >= 1")
    if cfg.pipeline_parallel > 1:
        if cfg.model != "transformer":
            raise ValueError("--pipeline_parallel requires "
                             "--model=transformer (the MLP has no stages)")
        if cfg.num_blocks % cfg.pipeline_parallel:
            raise ValueError(
                f"num_blocks={cfg.num_blocks} must divide evenly over "
                f"pipeline_parallel={cfg.pipeline_parallel}")
        if cfg.microbatches < 1:
            raise ValueError(f"microbatches={cfg.microbatches} must be >= 1")
        if cfg.fsdp or cfg.sync_period > 1:
            raise ValueError("--pipeline_parallel composes with data, "
                             "tensor, sequence and expert parallelism "
                             "only (no fsdp, sync_period=1)")
        if cfg.sequence_parallel > 1 and cfg.expert_parallel > 1:
            raise ValueError(
                "--pipeline_parallel composes with EITHER "
                "--sequence_parallel OR --expert_parallel (plus "
                "--model_parallel and data), not both at once")
    if cfg.pp_schedule not in ("gpipe", "1f1b"):
        raise ValueError(
            f"pp_schedule={cfg.pp_schedule!r}: expected 'gpipe' or "
            f"'1f1b'")
    if cfg.pp_schedule == "1f1b":
        if cfg.pipeline_parallel < 2:
            raise ValueError("--pp_schedule=1f1b requires "
                             "--pipeline_parallel > 1 (no schedule to "
                             "fuse on one stage)")
        if cfg.sequence_parallel > 1 or cfg.expert_parallel > 1:
            raise ValueError("--pp_schedule=1f1b composes with data "
                             "and tensor parallelism only (no "
                             "sequence/expert token sharding)")
        if cfg.moe_aux_weight:
            raise ValueError("--pp_schedule=1f1b does not carry the "
                             "MoE balance loss; use the gpipe "
                             "schedule with --moe_aux_weight")
        if cfg.grad_accum > 1:
            raise ValueError("--pp_schedule=1f1b already microbatches "
                             "the local batch; --grad_accum must be 1")
        if cfg.remat:
            raise ValueError("--remat has no effect under "
                             "--pp_schedule=1f1b (the fused schedule "
                             "already rematerializes per slot); drop "
                             "the flag or use --pp_schedule=gpipe")
    if cfg.virtual_stages < 1:
        raise ValueError(
            f"virtual_stages={cfg.virtual_stages} must be >= 1")
    if cfg.virtual_stages > 1:
        if cfg.pipeline_parallel < 2:
            raise ValueError("--virtual_stages > 1 needs "
                             "--pipeline_parallel > 1 (nothing to "
                             "interleave on one stage)")
        if cfg.num_blocks % (cfg.pipeline_parallel * cfg.virtual_stages):
            raise ValueError(
                f"num_blocks={cfg.num_blocks} must divide evenly over "
                f"pipeline_parallel*virtual_stages="
                f"{cfg.pipeline_parallel * cfg.virtual_stages}")
        if cfg.microbatches % cfg.pipeline_parallel:
            raise ValueError(
                f"interleaved stages need microbatches "
                f"({cfg.microbatches}) divisible by pipeline_parallel "
                f"({cfg.pipeline_parallel})")


# JAX's refusal of --fsdp and local SGD under --sequence_parallel (also
# the FSDP step's, should it be handed a mesh with a seq axis)
SP_COMPOSES_ONLY = ("--sequence_parallel composes with data and tensor "
                    "parallelism only (no fsdp, sync_period=1)")


def validate_sequence_config(cfg: Config, seq_len: int) -> None:
    """The ``--sequence_parallel`` checks of the JAX trainer, its
    messages: the transformer only, no FSDP nor local SGD, the
    effective sequence length (``seq_len``: ``--input_size`` under
    ``--objective=lm``) split evenly, and under ``--sp_impl=ulysses``
    each model shard's heads split evenly."""
    if cfg.sequence_parallel <= 1:
        return
    if cfg.model != "transformer":
        raise ValueError("--sequence_parallel requires --model=transformer "
                         "(the MLP has no token axis)")
    if cfg.fsdp or cfg.sync_period > 1:
        raise ValueError(SP_COMPOSES_ONLY)
    if seq_len % cfg.sequence_parallel:
        raise ValueError(
            f"seq_len={seq_len} (from --input_size under "
            f"--objective=lm, else --seq_len) must divide evenly over "
            f"sequence_parallel={cfg.sequence_parallel}")
    local_heads = cfg.n_heads // max(cfg.model_parallel, 1)
    if cfg.sp_impl == "ulysses" and local_heads % cfg.sequence_parallel:
        raise ValueError(
            f"--sp_impl=ulysses shards attention heads: n_heads="
            f"{cfg.n_heads} (per model shard: {local_heads}) must "
            f"divide evenly over "
            f"sequence_parallel={cfg.sequence_parallel} "
            f"(use --sp_impl=ring for degrees beyond the head count)")


# JAX's refusal of --fsdp, local SGD and sequence parallelism under
# --expert_parallel (also the FSDP step's, should it be handed a mesh
# with an expert axis)
EP_COMPOSES_ONLY = ("--expert_parallel composes with data and tensor "
                    "parallelism only (no fsdp, sync_period=1, "
                    "sequence_parallel=1)")


def validate_expert_config(cfg: Config) -> None:
    """The ``--expert_parallel`` checks of the JAX trainer, its
    messages: a degree of at least 1, a MoE to shard (``--num_experts``
    > 0) whose experts split evenly over it, and no FSDP, local SGD or
    sequence parallelism beside it.  (``--sites`` with it is refused by
    ``validate_local_sgd_config``, as JAX's config does.)"""
    if cfg.expert_parallel < 1:
        raise ValueError(
            f"expert_parallel={cfg.expert_parallel} must be >= 1")
    if cfg.expert_parallel == 1:
        return
    if not cfg.num_experts:
        raise ValueError("--expert_parallel requires --num_experts > 0")
    if cfg.num_experts % cfg.expert_parallel:
        raise ValueError(
            f"num_experts={cfg.num_experts} must divide evenly over "
            f"expert_parallel={cfg.expert_parallel}")
    if cfg.fsdp or cfg.sync_period > 1 or cfg.sequence_parallel > 1:
        raise ValueError(EP_COMPOSES_ONLY)


def validate_resilience_config(cfg: Config) -> None:
    """The resilience flags' checks (the JAX ``validate_resilience_config``).

    - ``--resume`` is "" (fresh), "latest" (the classic formats) or
      "auto" (the newest valid resilience manifest, exact step);
    - ``--ckpt_every`` snapshots through the resilience store from the
      host path's per-step safe point and needs ``--checkpoint_dir``;
      not under ``--fsdp``, nor ``--resume=auto`` (the snapshot holds
      full logical leaves, not FSDP's flat shards);
    - ``--ckpt_keep`` is the store's retention and needs
      ``--ckpt_every`` (the classic formats have ``--keep_checkpoints``).
    """
    if cfg.resume not in ("", "latest", "auto", True, False):
        raise ValueError(
            f"resume={cfg.resume!r}: expected '' (fresh), 'latest' "
            f"(bare --resume / legacy True) or 'auto' (exact-step "
            f"resilience resume)")
    if cfg.ckpt_every < 0:
        raise ValueError(f"ckpt_every={cfg.ckpt_every} must be >= 0")
    if cfg.ckpt_keep < 0:
        raise ValueError(f"ckpt_keep={cfg.ckpt_keep} must be >= 0")
    if cfg.ckpt_keep and not cfg.ckpt_every:
        raise ValueError(
            "--ckpt_keep is the resilience store's retention; it "
            "needs --ckpt_every > 0 (the classic formats use "
            "--keep_checkpoints)")
    if cfg.ckpt_every:
        if not cfg.checkpoint_dir:
            raise ValueError(
                "--ckpt_every needs --checkpoint_dir (the resilience "
                "store lives there)")
        if cfg.fsdp:
            raise ValueError(
                "--ckpt_every does not compose with --fsdp: the "
                "resilience snapshot holds full logical leaves, not "
                "the fsdp flat-sharded host layout (use "
                "--checkpoint_every with --sharded_checkpoints)")
    if cfg.resume == "auto" and cfg.fsdp:
        raise ValueError(
            "--resume=auto restores full logical leaves from the "
            "resilience manifest, which the fsdp flat-sharded "
            "template cannot receive; use bare --resume with the "
            "classic formats under --fsdp")


def validate_train_config(cfg: Config) -> None:
    """Value checks of the ported training flags; ``Unported`` for a
    mode of the JAX trainer the port does not have."""
    validate_strategy_config(cfg)
    validate_pipeline_config(cfg)
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
    if cfg.async_checkpoints and not cfg.sharded_checkpoints:
        raise ValueError("--async_checkpoints requires "
                         "--sharded_checkpoints (the portable single "
                         "file is written by the chief synchronously)")
    validate_span_config(cfg)
    validate_resilience_config(cfg)
    validate_monitoring_config(cfg)
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
    validate_expert_config(cfg)
    # the multi-site matrix, then the quantization one (--fp8_ffn,
    # --outer_quant), as the JAX trainer orders them
    validate_local_sgd_config(cfg)
    validate_quant_config(cfg)
