"""The name registries the serving spans and waterfalls use — the port's
copy of the JAX package's ``obs/buckets.py`` (its serving part).

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
side's span and ``route``/``failover`` the fleet router's narration;
the port emits neither yet, and the names stay so that a JAX stream
validates here.
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
