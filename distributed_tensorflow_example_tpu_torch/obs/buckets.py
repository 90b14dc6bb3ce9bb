"""The name registries of the port's ``obs/`` — its copy of the JAX
package's ``obs/buckets.py``.

``SPAN_EVENTS`` is the one vocabulary of the ``spans.<proc>.jsonl``
stream: ``SpanRecorder.emit`` refuses any other name, and
``obs/schema.py`` pins each event's fields, so a drifted event name
fails at the emit site.  Every accepted request ends in exactly one of
``retire`` (a result), ``timeout`` (deadline or client cancel),
``shed`` (a bounded-queue rejection, the one terminal without a
submit) or ``failed`` (the supervised engine's retry budget spent, or
through the legacy ``error`` row an unsupervised loop death).
``requeue`` marks a supervised re-admission, ``engine_restart`` one
supervised loop restart (carrying the in-flight rids, like a tick
row); ``tick_done`` closes the tick the scheduler's ``tick`` row
opened, with the execution-only ``dur_ms``.  ``phase`` is the training
side's span (the port's trainer emits none yet; the name stays so that a
JAX stream validates here) and ``route``/``failover`` the fleet router's
narration.

``WINDOW_BUCKETS``/``HOST_BUCKET`` name the timing fields of a metrics
window row, ``TRACE_SCOPES`` the ``torch.profiler`` and NVTX ranges the
trainer's ``--profile_steps`` capture annotates (``obs/tracer.py``),
``NAMED_SCOPES`` the regions inside the model, the engine and the
local-SGD round that ``obs/tracer.scope`` names (JAX's
``jax.named_scope`` names), and ``GOODPUT_BUCKETS`` the run report's
wall decomposition
(``obs/aggregate.py``); ``RESTART_EVENTS`` is the vocabulary of the
``restarts.jsonl`` timeline (``resilience/restart.RestartNarrator``).
"""

from __future__ import annotations

SPAN_EVENTS = ("submit", "blocked", "admit", "prefill", "first_token",
               "tick", "tick_done", "retire", "error", "timeout",
               "shed", "requeue", "engine_restart", "failed", "phase",
               "route", "failover")

# per-request latency waterfall segments (obs/waterfall.py), in
# presentation order: disjoint intervals that partition a request's
# submit->terminal wall.  "queue_wait" = submitted, not admitted;
# "brownout_clamp_delay" = blocked by the brownout governor; "prefill"
# = admit->first_token; "decode_active" = decode execution;
# "decode_stall" = tick gaps not covered by execution; "requeue" =
# engine-restart recovery until re-admission; "finalize" = last tick
# end->terminal bookkeeping; "untracked" = defensive residual (0).
WATERFALL_SEGMENTS = ("queue_wait", "brownout_clamp_delay", "prefill",
                      "decode_active", "decode_stall", "requeue",
                      "finalize", "untracked")

# valid "phase" span names (the training side's phase rows)
PHASE_SCOPES = ("round", "outer_sync", "ckpt")

# host-loop per-window charge buckets (field "<name>_s" in every metrics
# window row; "host" is the residual field computed from them)
WINDOW_BUCKETS = ("data_wait", "h2d", "dispatch", "device_wait", "ckpt")

# the residual bucket name (field "host_s"): wall not charged above
HOST_BUCKET = "host"

# valid WindowedTracer.annotate range names: the charge buckets plus the
# host phases outside the step window
TRACE_SCOPES = WINDOW_BUCKETS + ("eval", "checkpoint")

# the regions inside the step, in JAX's names and order (obs/tracer.scope
# opens them): "ln" every LayerNorm of the transformer (models/
# transformer._ln, _ln_residual); "moe_dispatch" the router, the
# selection and the combine, "moe_expert" the expert FFN between them
# (_moe_ffn, _moe_ffn_sparse); "pp_comm" a stage hop (the pipeline's
# hop); "prefill", "decode" and "sampling" the engine's prompt
# ingestion, paged decode step and token draw (serving/engine.py);
# "outer_sync" the multi-site round's cross-site mean and outer update
# (parallel/local_sgd.py); "quant" the quantize/dequantize edges (the
# int8 KV pool in serving/kv_cache.py, the fp8 operand rounding in
# ops/fused.py, the compressed outer sync), so a capture attributes the
# conversions apart from the compute they feed.  A range covers the
# forward's operators: autograd's backward runs outside it
NAMED_SCOPES = ("ln", "moe_dispatch", "moe_expert", "pp_comm",
                "prefill", "decode", "sampling", "outer_sync",
                "quant")

# run-level goodput/badput decomposition, in presentation order ("train"
# is the goodput bucket, "eval"/"sample" auxiliary useful work, the rest
# badput); aggregate.BUCKETS re-exports this
GOODPUT_BUCKETS = ("train", "compile", "data_wait", "h2d", "ckpt",
                   "host", "eval", "sample", "anomaly_skipped",
                   "straggler_idle", "untracked")

# restart-timeline events (RestartNarrator appends them to
# restarts.jsonl; obs/aggregate.py folds them into the run report): the
# preemption/recovery lifecycle, the chief-side elastic decisions, and
# "engine_restart", the serving supervisor's entry (the decode-engine
# loop died and was restarted in place with its in-flight requests
# re-queued)
RESTART_EVENTS = ("preempt", "snapshot", "resumed", "dead_proc",
                  "attempt_start", "attempt_exit", "retry", "reform",
                  "give_up", "engine_restart")
