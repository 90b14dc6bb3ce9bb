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
- ``GET /healthz`` — ``{"ok": true, "serving": <engine stats>}``.

``--replicas`` > 1, ``--replay``, ``--trace_spans`` and ``--slo`` are
not ported yet: the CLI exits 2 with a message naming ROADMAP.md.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Sequence

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
    attention.  (The prefill and the decode run dense attention
    whatever the spec says, as in the JAX package.)"""
    from ..device import dtype_from_name
    from ..models.transformer import TransformerSpec

    return TransformerSpec(
        input_size=cfg.input_size, objective="lm",
        vocab_size=cfg.vocab_size, seq_len=cfg.input_size,
        d_model=cfg.d_model, n_heads=cfg.n_heads,
        num_blocks=cfg.num_blocks, d_ff=cfg.d_ff,
        activation=(cfg.activation if cfg.activation != "sigmoid"
                    else "gelu"),
        attention="flash" if cfg.pallas else cfg.attention,
        causal=True, num_experts=cfg.num_experts,
        fused_ln=cfg.fused_ln, fp8_ffn=cfg.fp8_ffn,
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
    if cfg.trace_spans:
        out.append("--trace_spans")
    if cfg.slo:
        out.append("--slo")
    if cfg.kv_quant:
        out.append("--kv_quant")
    if cfg.num_experts:
        out.append("--num_experts")
    # flags of the fleet, replay, span and status-server features, which
    # the port does not have either: refused when set off their defaults
    defaults = config_lib.Config()
    for name in ("replay_speed", "fleet_retries", "breaker",
                 "span_rotate_mb", "span_keep", "status_cache_s"):
        if getattr(cfg, name) != getattr(defaults, name):
            out.append(f"--{name}")
    return out


def build_engine(cfg):
    """The ``DecodeEngine`` the flags describe (not started)."""
    from ..models import transformer as tfm
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
    return DecodeEngine(
        spec, params, page_size=cfg.decode_page_size,
        num_pages=cfg.decode_pages, max_batch=cfg.decode_max_batch,
        seed=cfg.seed, max_queue=cfg.max_queue,
        deadline_ms=cfg.deadline_ms, engine_retries=cfg.engine_retries,
        brownout=parse_brownout(cfg.brownout), device=cfg.device)


class GenerateServer:
    """``POST /generate`` + ``GET /healthz`` over one engine, from a
    daemon thread.  ``start(port)`` binds (0 = an ephemeral port) and
    returns the bound port, or None when the bind fails; ``close()``
    shuts the listener down."""

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
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                if path == "/healthz":
                    self._send(200, {"ok": True, "serving": engine.stats()})
                else:
                    self._send(404, {"error": f"unknown path {path!r}",
                                     "endpoints": ["/generate",
                                                   "/healthz"]})

            def do_POST(self):
                from .admission import ShedError, retry_after_header
                from .engine import new_trace_id

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
                headers = ({"traceparent": f"00-{ctx[0]}-"
                                           f"{new_trace_id()[:16]}-01"}
                           if ctx else None)
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
    server and stop the engine when done.  Raises RuntimeError when
    the port cannot be bound."""
    engine = build_engine(cfg)
    engine.start()
    server = GenerateServer(engine)
    if server.start(port) is None:
        engine.stop()
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
    try:
        config_lib.validate_serving_config(cfg)
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
          f"max_len={engine.max_len})", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
        engine.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
