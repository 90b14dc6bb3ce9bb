"""The port's serving front door: ``dtx-serve`` over one engine or a
fleet.

    python -m distributed_tensorflow_example_tpu_torch.serving.cli \\
        --serve_port 8437 --model=transformer --objective=lm \\
        --input_size=1024 --vocab_size=256 --d_model=1024 --n_heads=8 \\
        --num_blocks=4 --d_ff=4096 --activation=gelu \\
        --compute_dtype=bfloat16 --fused_ln --fp8_ffn [--replicas 2]

Builds the transformer spec from the JAX package's flag names, loads
params from a JAX training checkpoint (``--checkpoint_dir``) or makes a
seeded random init (demo mode) on the card once (``--device cpu`` to run
on the CPU), and serves with stdlib ``http.server``:

- one engine (``--replicas 1``): the continuous-batching
  ``DecodeEngine`` behind ``obs/serve.StatusServer`` — ``POST
  /generate``, ``GET /``, ``/status``, ``/metrics``, ``/report``,
  ``/slo``, ``/trace?rid=N``, ``/fleet``, ``/explain`` with the JAX
  status server's payloads and codes, and ``/healthz``;
- a fleet (``--replicas N`` > 1): N engines sharing the one copy of the
  params on the card, each with its own thread, behind
  ``serving/router.RouterServer`` — ``POST /generate`` placed least
  loaded over health with per-replica circuit breakers (``--breaker``)
  and failover (``--fleet_retries``), ``GET /status`` with the
  per-replica section, ``/metrics`` with the ``dtx_router_*`` gauges;
  SIGTERM drains.

``--trace_spans`` records request spans under ``<logs_path>`` (one
engine) or ``<logs_path>/replica<i>`` and ``<logs_path>/router`` (a
fleet); ``--engine_retries`` > 0 supervises each engine loop and
narrates every restart to ``<logs_path>/restarts.jsonl``;
``--status_cache_s`` is the status server's cache lifetime;
``--kv_quant=int8`` stores the paged pools as int8, and a MoE model
(``--num_experts``) decodes by exact dense dispatch.

``--replay workload.json`` serves no HTTP: it feeds a captured or
synthetic WORKLOAD (``obs/workload.py``) through one engine or the
``--replicas`` fleet at the recorded arrival offsets, ``--replay_speed``
times faster, and prints the replay report JSON as the only thing on
stdout (``serving/replay.py``; exit 0, 1 when a request wedged, 2 on an
unreadable workload).  Under ``--trace_spans`` every span row carries
``replay_of: <workload_id>``.  The engines are warmed up before the
replay's clock starts: the kernel library's build and the first call at
each shape are not part of the replayed schedule.

The CLI parses the trainer's multi-site flags too (``--sites``,
``--inner_steps``, ``--outer_*``), as JAX's shared parser does: they
change nothing it serves, and ``--outer_quant`` without ``--sites`` > 1
exits 2 with JAX's message.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Optional, Sequence

from .. import config as config_lib


def spec_from_cfg(cfg):
    """The lm transformer spec of the JAX ``dtx-serve``'s
    ``_spec_from_cfg``: seq_len = input_size, causal, ``sigmoid``
    (the training default) served as gelu, ``--pallas`` selects flash
    attention, every MoE field carried.  (The prefill and the decode
    run dense attention and dense MoE dispatch whatever the spec says,
    as in the JAX package.)"""
    from ..device import dtype_from_name
    from ..models.transformer import TransformerSpec

    return TransformerSpec(
        input_size=cfg.input_size, num_classes=cfg.num_classes,
        objective="lm", vocab_size=cfg.vocab_size,
        seq_len=cfg.input_size,
        d_model=cfg.d_model, n_heads=cfg.n_heads,
        num_blocks=cfg.num_blocks, d_ff=cfg.d_ff,
        activation=(cfg.activation if cfg.activation != "sigmoid"
                    else "gelu"),
        attention="flash" if cfg.pallas else cfg.attention,
        causal=True, num_experts=cfg.num_experts, moe_topk=cfg.moe_topk,
        moe_dispatch=cfg.moe_dispatch,
        capacity_factor=cfg.capacity_factor,
        aux_loss_weight=cfg.moe_aux_weight,
        fused_ln=cfg.fused_ln, grouped_moe=cfg.grouped_moe,
        fp8_ffn=cfg.fp8_ffn,
        param_dtype=dtype_from_name(cfg.param_dtype),
        compute_dtype=dtype_from_name(cfg.compute_dtype),
    )


def load_params(cfg, spec) -> dict:
    """The served params on ``cfg.device``, loaded once: from the JAX
    training checkpoint under ``--checkpoint_dir``, else a seeded random
    init (demo mode).  Engines built over this dict share its tensors
    (``DecodeEngine`` moves params with ``.to``, a no-op on the same
    device), so N replicas hold one copy."""
    from ..models import transformer as tfm

    if cfg.checkpoint_dir:
        from ..convert import params_from_checkpoint

        params, path = params_from_checkpoint(cfg.checkpoint_dir, spec,
                                              device=cfg.device)
        print(f"dtx-serve (torch): params restored from {path}",
              file=sys.stderr)
        return params
    print("dtx-serve (torch): no --checkpoint_dir — serving a seeded "
          "random init (demo mode)", file=sys.stderr)
    return tfm.init(spec, seed=cfg.seed, device=cfg.device)


def make_recorder(cfg, sub: str = "", replay_of: Optional[str] = None):
    """A ``SpanRecorder`` under ``<logs_path>[/sub]`` when
    ``--trace_spans`` is set, else None; with ``replay_of`` (a workload
    id) every row it writes carries ``replay_of``."""
    if not cfg.trace_spans:
        return None
    from ..obs.spans import SpanRecorder

    return SpanRecorder(
        os.path.join(cfg.logs_path, sub) if sub else cfg.logs_path,
        rotate_bytes=int(cfg.span_rotate_mb * 1024 * 1024),
        keep=cfg.span_keep,
        extra={"replay_of": replay_of} if replay_of else None)


def make_narrator(cfg):
    """The ``RestartNarrator`` on ``<logs_path>/restarts.jsonl`` when
    ``--engine_retries`` > 0 (the JAX ``dtx-serve``'s rule, one engine
    or a fleet), else None."""
    if cfg.engine_retries <= 0:
        return None
    from ..resilience.restart import RestartNarrator

    return RestartNarrator(cfg.logs_path)


def build_engine(cfg, spec=None, params=None, sub: str = "",
                 narrator=None, replay_of: Optional[str] = None):
    """The ``DecodeEngine`` the flags describe (not started), over
    ``params`` (None: ``load_params``), with a recorder under
    ``<logs_path>[/sub]`` when ``--trace_spans`` is set (close it with
    ``engine.recorder.close()`` when done; ``replay_of`` stamps its
    rows) and ``narrator`` (None: a new one when ``--engine_retries`` >
    0)."""
    from ..obs import slo as slo_lib
    from .admission import parse_brownout
    from .engine import DecodeEngine

    spec = spec if spec is not None else spec_from_cfg(cfg)
    if params is None:
        params = load_params(cfg, spec)
    recorder = make_recorder(cfg, sub, replay_of)
    if recorder is not None and not sub:
        print(f"dtx-serve (torch): request spans -> {recorder.path}"
              + (f" (rotate at {cfg.span_rotate_mb:g} MB, keep "
                 f"{cfg.span_keep})" if cfg.span_rotate_mb > 0
                 else ""), file=sys.stderr)
    return DecodeEngine(
        spec, params, page_size=cfg.decode_page_size,
        num_pages=cfg.decode_pages, max_batch=cfg.decode_max_batch,
        seed=cfg.seed, kv_quant=cfg.kv_quant, recorder=recorder,
        max_queue=cfg.max_queue, deadline_ms=cfg.deadline_ms,
        engine_retries=cfg.engine_retries,
        brownout=parse_brownout(cfg.brownout),
        slos=slo_lib.parse_specs(cfg.slo),
        restart_narrator=(narrator if narrator is not None
                          else make_narrator(cfg)),
        device=cfg.device)


def build_fleet(cfg, spec=None, params=None,
                replay_of: Optional[str] = None):
    """``(router, engines)``: ``--replicas`` engines (not started) over
    one ``load_params`` copy (or ``params``), engine i's recorder under
    ``<logs_path>/replica<i>``, one shared narrator, behind a ``Router``
    with ``--fleet_retries`` and the ``--breaker`` policy and its own
    recorder under ``<logs_path>/router`` (``replay_of`` stamps every
    recorder's rows)."""
    from .health import parse_breaker
    from .router import Router

    spec = spec if spec is not None else spec_from_cfg(cfg)
    if params is None:
        params = load_params(cfg, spec)
    narrator = make_narrator(cfg)
    engines = [build_engine(cfg, spec, params, sub=f"replica{i}",
                            narrator=narrator, replay_of=replay_of)
               for i in range(cfg.replicas)]
    router = Router(engines, fleet_retries=cfg.fleet_retries,
                    breaker=parse_breaker(cfg.breaker or "on"),
                    recorder=make_recorder(cfg, "router", replay_of))
    return router, engines


def stop_engines(engines, router=None) -> None:
    """Stop every engine and close every recorder (the engines' and the
    router's)."""
    for e in engines:
        e.stop()
    recs = [e.recorder for e in engines]
    if router is not None:
        recs.append(router.recorder)
    for rec in recs:
        if rec is not None:
            rec.close()


def serve(cfg, port: int):
    """Build and start one engine and the ``StatusServer`` over
    ``<logs_path>`` on ``port`` (0 = ephemeral); returns ``(server,
    engine)``, both running — close the server and ``stop_engines([engine])``
    when done.  Raises RuntimeError when the port cannot be bound."""
    from ..obs import slo as slo_lib
    from ..obs.serve import StatusServer

    engine = build_engine(cfg)
    engine.start()
    server = StatusServer(cfg.logs_path, engine=engine,
                          slos=slo_lib.parse_specs(cfg.slo),
                          cache_ttl_s=cfg.status_cache_s)
    if server.start(port) is None:
        stop_engines([engine])
        raise RuntimeError(f"could not bind port {port}")
    return server, engine


def serve_fleet(cfg, port: int):
    """Build and start the ``--replicas`` fleet (``build_fleet``) behind
    a ``RouterServer`` on ``port``; returns ``(server, router,
    engines)``, all running — close the server and
    ``stop_engines(engines, router)`` when done.  Raises RuntimeError
    when the port cannot be bound."""
    from .router import RouterServer

    router, engines = build_fleet(cfg)
    for e in engines:
        e.start()
    server = RouterServer(router)
    if server.start(port) is None:
        stop_engines(engines, router)
        raise RuntimeError(f"could not bind port {port}")
    return server, router, engines


def _main_fleet(cfg) -> int:
    """``--replicas N`` > 1: serve until SIGTERM drains the router (stop
    admitting, finish in-flight, typed-shed the queue) or Ctrl-C."""
    try:
        server, router, engines = serve_fleet(cfg, cfg.serve_port)
    except RuntimeError as e:
        print(f"dtx-serve (torch): {e}", file=sys.stderr)
        return 2
    from .health import parse_breaker

    server.install_sigterm()
    print(f"dtx-serve (torch): fleet of {cfg.replicas} replicas behind "
          f"POST /generate on :{server.port} (device={engines[0].device} "
          f"fleet_retries={cfg.fleet_retries} breaker=failures:"
          f"{parse_breaker(cfg.breaker or 'on').failures}"
          + (f" engine_retries={cfg.engine_retries}"
             if cfg.engine_retries else "")
          + (f" spans -> {cfg.logs_path}/replica<i>"
             if cfg.trace_spans else "") + ")", flush=True)
    try:
        while not router.draining:
            time.sleep(0.5)
        # SIGTERM drained the router: let the in-flight decodes retire
        while any(e.stats().get("inflight", 0) for e in engines):
            time.sleep(0.1)
        print("dtx-serve (torch): fleet drained, exiting", flush=True)
    except KeyboardInterrupt:
        router.drain()
    finally:
        server.close()
        stop_engines(engines, router)
    return 0


def warm_up(cfg, spec, params) -> None:
    """Run a throwaway engine (no recorder, no narrator) of the flags'
    shape over ``params`` until idle: ``--decode_max_batch`` requests
    of staggered prompt and output lengths, so the kernel library is
    built and every decode batch bucket has run once before a replay
    starts its clock."""
    from .engine import DecodeEngine

    eng = DecodeEngine(spec, params, page_size=cfg.decode_page_size,
                       num_pages=cfg.decode_pages,
                       max_batch=cfg.decode_max_batch, seed=cfg.seed,
                       kv_quant=cfg.kv_quant, device=cfg.device)
    top = max(1, min(eng.max_len - 1, 64))
    for i in range(eng.max_batch):
        eng.submit([1 + (t % (spec.vocab_size - 1))
                    for t in range(1 + (i * top) // eng.max_batch)],
                   min(i + 1, eng.max_len - top))
    eng.run_until_idle()


def settle(engines, timeout: float = 10.0) -> None:
    """Let each engine reach its final tick boundary (the retire row
    lands one boundary after the result that unblocked the caller)."""
    deadline = time.monotonic() + timeout
    for e in engines:
        while time.monotonic() < deadline:
            if not e.sched.live and not e.sched.waiting:
                time.sleep(0.05)
                break
            time.sleep(0.02)


def _main_replay(cfg) -> int:
    """``--replay workload.json``: feed the WORKLOAD through one engine
    or the ``--replicas`` fleet at its arrival offsets (scaled by
    ``--replay_speed``) and print the replay report JSON, the only
    thing on stdout.  Exit 0 when every request reached a typed
    terminal, 1 when any wedged, 2 on an unreadable workload."""
    import json

    from ..obs.workload import load_workload
    from . import replay as replay_lib

    try:
        doc = load_workload(cfg.replay)
    except (OSError, ValueError, KeyError) as e:
        print(f"dtx-serve (torch): --replay: {e}", file=sys.stderr)
        return 2
    wid = doc["workload_id"]
    spec = spec_from_cfg(cfg)
    params = load_params(cfg, spec)
    warm_up(cfg, spec, params)
    router = None
    if cfg.replicas > 1:
        router, engines = build_fleet(cfg, spec, params, replay_of=wid)
        target = router
    else:
        engines = [build_engine(cfg, spec, params, replay_of=wid)]
        target = engines[0]
    for e in engines:
        e.start()
    print(f"dtx-serve (torch): replaying {wid} ({doc['n_requests']} "
          f"requests over {doc['duration_s']:g}s recorded) at "
          f"x{cfg.replay_speed:g}"
          + (f" across {cfg.replicas} replicas"
             if cfg.replicas > 1 else ""), file=sys.stderr)
    try:
        report = replay_lib.replay_engine(
            target, doc, vocab_size=cfg.vocab_size,
            speed=cfg.replay_speed, seed=cfg.seed)
    finally:
        settle(engines)
        stop_engines(engines, router)
    print(json.dumps(report, indent=1, sort_keys=True))
    return 0 if not report["terminals"].get("wedged") else 1


def main(argv: Optional[Sequence[str]] = None) -> int:
    cfg = config_lib.parse_config(argv)
    if cfg.serve_port <= 0 and not cfg.replay:
        print("dtx-serve (torch): --serve_port is required (> 0)",
              file=sys.stderr)
        return 2
    if cfg.model != "transformer" or cfg.objective != "lm":
        print("dtx-serve (torch): decoding needs --model=transformer "
              "--objective=lm", file=sys.stderr)
        return 2
    from ..obs import slo as slo_lib

    try:
        config_lib.validate_quant_config(cfg)
        config_lib.validate_serving_config(cfg)
        slo_lib.parse_specs(cfg.slo)
    except ValueError as e:
        print(f"dtx-serve (torch): {e}", file=sys.stderr)
        return 2
    if cfg.replay:
        return _main_replay(cfg)
    if cfg.replicas > 1:
        return _main_fleet(cfg)
    try:
        server, engine = serve(cfg, cfg.serve_port)
    except RuntimeError as e:
        print(f"dtx-serve (torch): {e}", file=sys.stderr)
        return 2
    if engine.restart_narrator is not None:
        print(f"dtx-serve (torch): engine supervision armed "
              f"(engine_retries={cfg.engine_retries}; restarts -> "
              f"{engine.restart_narrator.path})", flush=True)
    print(f"dtx-serve (torch): POST /generate on :{server.port} "
          f"(device={engine.device} page_size={engine.page_size} "
          f"pages={engine.num_pages} max_batch={engine.max_batch} "
          f"max_len={engine.max_len}"
          + (f" kv_quant={engine.kv_quant}" if engine.kv_quant else "")
          + (f" deadline_ms={engine.deadline_ms:g}"
             if engine.deadline_ms else "")
          + (f" max_queue={engine.max_queue}"
             if engine.max_queue else "")
          + (" brownout=on" if engine.brownout is not None else "")
          + ")", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
        stop_engines([engine])
    return 0


if __name__ == "__main__":
    sys.exit(main())
