"""The port's serving front door (one engine).

    python -m distributed_tensorflow_example_tpu_torch.serving.cli \\
        --serve_port 8437 --model=transformer --objective=lm \\
        --input_size=1024 --vocab_size=256 --d_model=1024 --n_heads=8 \\
        --num_blocks=4 --d_ff=4096 --activation=gelu \\
        --compute_dtype=bfloat16 --fused_ln --fp8_ffn

Builds the transformer spec from the JAX package's flag names, loads
params from a JAX training checkpoint (``--checkpoint_dir``) or makes a
seeded random init (demo mode), starts the continuous-batching
``DecodeEngine`` on the card (``--device cpu`` to run on the CPU), and
serves with stdlib ``http.server``:

- ``POST /generate`` — ``{"prompt": [ints], "max_new_tokens": N,
  "temperature": t, "deadline_ms": d}`` -> the JAX front door's
  response keys (``rid``, ``status``, ``prompt``, ``tokens``,
  ``latency_ms``, ``ttft_ms``, ``trace_id``); 503 + ``Retry-After``
  when shed, 504 on a deadline, 400 on a bad request;
- ``GET /healthz`` — ``{"ok": true, "serving": <engine stats>}``;
- ``GET /slo`` — the burn-rate verdict of the ``--slo`` specs;
- ``GET /trace?rid=N`` — one request's reconstructed lifecycle and its
  raw span rows (400 without an integer rid, 404 for an unknown one);
- ``GET /explain[?rid=N][&trace=ID]`` — per-request latency waterfalls
  and their summary;

the last three with the JAX status server's payloads, read from the
span recorder's ring (``--trace_spans``; without it they see no
requests).  ``--kv_quant=int8`` stores the paged pools as int8, and a
MoE model (``--num_experts``) decodes by exact dense dispatch.

The fleet (``--replicas`` > 1, ``--breaker``, ``--fleet_retries``),
replay (``--replay``, ``--replay_speed``), the status server's cache
(``--status_cache_s``) and ``--outer_quant`` are not ported yet: set,
the CLI exits 2 with a message naming ROADMAP.md.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Sequence
from urllib.parse import parse_qs

from .. import config as config_lib

# the /generate handler's ceiling wait; a request with its own
# deadline waits deadline + grace (the engine retires it AT the
# deadline with a typed timeout terminal)
GENERATE_TIMEOUT_S = 600.0
GENERATE_DEADLINE_GRACE_S = 5.0


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


def unported_flags(cfg) -> list:
    """The set flags of features the port does not have yet."""
    out = []
    if cfg.replicas > 1:
        out.append("--replicas")
    if cfg.replay:
        out.append("--replay")
    if cfg.outer_quant:
        out.append("--outer_quant")
    # flags of the fleet, replay and status-server features, which the
    # port does not have either: refused when set off their defaults
    defaults = config_lib.Config()
    for name in ("replay_speed", "fleet_retries", "breaker",
                 "status_cache_s"):
        if getattr(cfg, name) != getattr(defaults, name):
            out.append(f"--{name}")
    return out


def build_engine(cfg):
    """The ``DecodeEngine`` the flags describe (not started), with a
    ``SpanRecorder`` under ``<logs_path>`` when ``--trace_spans`` is
    set (close it with ``engine.recorder.close()`` when done)."""
    from ..models import transformer as tfm
    from ..obs import slo as slo_lib
    from .admission import parse_brownout
    from .engine import DecodeEngine

    spec = spec_from_cfg(cfg)
    if cfg.checkpoint_dir:
        from ..convert import params_from_checkpoint

        params, path = params_from_checkpoint(cfg.checkpoint_dir, spec,
                                              device=cfg.device)
        print(f"dtx-serve (torch): params restored from {path}",
              file=sys.stderr)
    else:
        print("dtx-serve (torch): no --checkpoint_dir — serving a seeded "
              "random init (demo mode)", file=sys.stderr)
        params = tfm.init(spec, seed=cfg.seed, device=cfg.device)
    recorder = None
    if cfg.trace_spans:
        from ..obs.spans import SpanRecorder

        recorder = SpanRecorder(
            cfg.logs_path,
            rotate_bytes=int(cfg.span_rotate_mb * 1024 * 1024),
            keep=cfg.span_keep)
        print(f"dtx-serve (torch): request spans -> {recorder.path}"
              + (f" (rotate at {cfg.span_rotate_mb:g} MB, keep "
                 f"{cfg.span_keep})" if cfg.span_rotate_mb > 0
                 else ""))
    return DecodeEngine(
        spec, params, page_size=cfg.decode_page_size,
        num_pages=cfg.decode_pages, max_batch=cfg.decode_max_batch,
        seed=cfg.seed, kv_quant=cfg.kv_quant, recorder=recorder,
        max_queue=cfg.max_queue, deadline_ms=cfg.deadline_ms,
        engine_retries=cfg.engine_retries,
        brownout=parse_brownout(cfg.brownout),
        slos=slo_lib.parse_specs(cfg.slo), device=cfg.device)


# the GET endpoints GenerateServer answers (its 404 names them)
ENDPOINTS = ["/generate", "/healthz", "/slo", "/trace", "/explain"]


def _span_rows(engine) -> list:
    """The /slo, /trace and /explain data: the recorder's ring (no file
    re-read per request); no rows without a recorder."""
    rec = getattr(engine, "recorder", None)
    return rec.snapshot() if rec is not None else []


def get_doc(engine, path: str, query: str):
    """``(status code, JSON doc)`` of a GET on ``path`` with the query
    string ``query``: the JAX status server's payloads, status codes
    and error bodies for /slo, /trace and /explain."""
    from ..obs import slo as slo_lib
    from ..obs import waterfall as wf_lib
    from ..obs.spans import trace_record

    if path == "/healthz":
        return 200, {"ok": True, "serving": engine.stats()}
    if path == "/slo":
        return 200, slo_lib.evaluate(
            slo_lib.records_from_spans(_span_rows(engine)),
            specs=engine.slos)
    if path == "/trace":
        rid = (parse_qs(query).get("rid") or [None])[0]
        try:
            rid = int(rid)
        except (TypeError, ValueError):
            return 400, {"error": "/trace needs ?rid=N (an integer "
                                  "request id)"}
        doc = trace_record(_span_rows(engine), rid)
        if doc is None:
            return 404, {"error": f"rid {rid} not in the span stream "
                                  f"tails"}
        return 200, doc
    if path == "/explain":
        q = parse_qs(query)
        docs = wf_lib.waterfalls(_span_rows(engine))
        rid_q = (q.get("rid") or [None])[0]
        if rid_q is not None:
            try:
                rid_q = int(rid_q)
            except ValueError:
                return 400, {"error": "?rid=N must be an integer"}
            docs = [d for d in docs if d["rid"] == rid_q]
        trace_q = (q.get("trace") or [None])[0]
        if trace_q is not None:
            docs = [d for d in docs if d.get("trace_id") == trace_q]
        return 200, {"summary": wf_lib.summarize(docs), "waterfalls": docs}
    return 404, {"error": f"unknown path {path!r}", "endpoints": ENDPOINTS}


class GenerateServer:
    """``POST /generate`` and the GET endpoints of ``get_doc`` over one
    engine, from a daemon thread.  ``start(port)`` binds (0 = an
    ephemeral port) and returns the bound port, or None when the bind
    fails; ``close()`` shuts the listener down."""

    def __init__(self, engine):
        self.engine = engine
        self.port: Optional[int] = None
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self, port: int, host: str = "") -> Optional[int]:
        engine = self.engine

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code: int, doc: dict,
                      headers: Optional[Dict[str, str]] = None) -> None:
                body = json.dumps(doc).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path, _, query = self.path.partition("?")
                path = path.rstrip("/") or "/"
                try:
                    code, doc = get_doc(engine, path, query)
                except Exception as e:  # a bad read must not kill serving
                    code, doc = 500, {"error": f"{type(e).__name__}: {e}"}
                self._send(code, doc)

            def do_POST(self):
                from ..obs.spans import format_traceparent, new_span_id
                from .admission import ShedError, retry_after_header

                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                if path != "/generate":
                    self._send(404, {"error": f"unknown POST path "
                                              f"{path!r}"})
                    return
                try:
                    n = int(self.headers.get("Content-Length") or 0)
                    req = json.loads(self.rfile.read(n) or b"{}")
                    prompt = req.get("prompt")
                    if not isinstance(prompt, list):
                        raise ValueError(
                            "'prompt' must be a list of token ids")
                    deadline_ms = req.get("deadline_ms")
                    if deadline_ms is not None:
                        deadline_ms = float(deadline_ms)
                        if deadline_ms < 0:
                            raise ValueError("'deadline_ms' must be "
                                             ">= 0")
                    rid = engine.submit(
                        prompt, int(req.get("max_new_tokens", 16)),
                        temperature=float(req.get("temperature", 0.0)),
                        deadline_ms=deadline_ms,
                        traceparent=self.headers.get("traceparent"))
                except ShedError as e:
                    self._send(503, {"error": str(e), "status": "shed",
                                     "retry_after_s": e.retry_after_s},
                               headers={"Retry-After": str(
                                   retry_after_header(e.retry_after_s))})
                    return
                except (ValueError, TypeError, KeyError) as e:
                    self._send(400, {"error": f"{type(e).__name__}: {e}"})
                    return
                except RuntimeError as e:
                    # the engine loop died: the server is up,
                    # generation is not
                    self._send(503, {"error": f"{type(e).__name__}: {e}"})
                    return
                ctx = engine.trace_context(rid)
                headers = ({"traceparent": format_traceparent(
                    ctx[0], new_span_id())} if ctx else None)
                if deadline_ms is None:
                    deadline_ms = engine.deadline_ms
                wait_s = GENERATE_TIMEOUT_S
                if deadline_ms and deadline_ms > 0:
                    wait_s = min(wait_s, deadline_ms / 1e3
                                 + GENERATE_DEADLINE_GRACE_S)
                res = engine.result(rid, timeout=wait_s)
                if res is None:
                    engine.cancel(rid)
                    self._send(504, {"error": "generation timed out",
                                     "status": "timeout", "rid": rid},
                               headers=headers)
                elif res.get("status") == "timeout":
                    self._send(504, res, headers=headers)
                elif "error" in res:
                    self._send(500, res, headers=headers)
                else:
                    self._send(200, res, headers=headers)

        try:
            self._httpd = ThreadingHTTPServer((host, int(port)), Handler)
        except OSError as e:
            print(f"dtx-serve (torch): failed to bind port {port}: {e}",
                  file=sys.stderr)
            return None
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="dtx-generate", daemon=True)
        self._thread.start()
        return self.port

    def close(self) -> None:
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


def serve(cfg, port: int):
    """Build and start the engine and the HTTP server on ``port`` (0 =
    ephemeral); returns ``(server, engine)``, both running — close the
    server, stop the engine and close its recorder (if any) when done.
    Raises RuntimeError when the port cannot be bound."""
    engine = build_engine(cfg)
    engine.start()
    server = GenerateServer(engine)
    if server.start(port) is None:
        engine.stop()
        if engine.recorder is not None:
            engine.recorder.close()
        raise RuntimeError(f"could not bind port {port}")
    return server, engine


def main(argv: Optional[Sequence[str]] = None) -> int:
    cfg = config_lib.parse_config(argv)
    if cfg.serve_port <= 0:
        print("dtx-serve (torch): --serve_port is required (> 0)",
              file=sys.stderr)
        return 2
    if cfg.model != "transformer" or cfg.objective != "lm":
        print("dtx-serve (torch): decoding needs --model=transformer "
              "--objective=lm", file=sys.stderr)
        return 2
    missing = unported_flags(cfg)
    if missing:
        print(f"dtx-serve (torch): {', '.join(missing)} not ported to "
              f"the PyTorch package yet (see ROADMAP.md Queue A)",
              file=sys.stderr)
        return 2
    from ..obs import slo as slo_lib

    try:
        config_lib.validate_quant_config(cfg)
        config_lib.validate_serving_config(cfg)
        slo_lib.parse_specs(cfg.slo)
    except ValueError as e:
        print(f"dtx-serve (torch): {e}", file=sys.stderr)
        return 2
    try:
        server, engine = serve(cfg, cfg.serve_port)
    except RuntimeError as e:
        print(f"dtx-serve (torch): {e}", file=sys.stderr)
        return 2
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
        engine.stop()
        if engine.recorder is not None:
            engine.recorder.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
