"""The PyTorch port's serving stack against the JAX package's, on the
CPU, at the ``tests/test_serving.py`` sizes (f32).

- The port's ``DecodeEngine`` with both flags off is token-identical
  to JAX ``generate`` across page sizes 4/8/16 (ragged prompts,
  admission churn through 3 slots).
- With ``fused_ln`` + ``fp8_ffn`` it is token-identical to the JAX
  ``DecodeEngine`` given the same requests, page size and
  ``max_batch`` (not to ``generate``: the fp8 per-tensor scale spans the
  whole padded decode batch, so batching changes the numbers).
- The copied pure-Python scheduler agrees with the JAX package's; the
  HTTP front door (``obs/serve.StatusServer`` through ``cli.serve``)
  answers ``POST /generate`` and, with ``--trace_spans``, ``GET /slo``,
  ``/trace``, ``/explain`` and ``/metrics`` with the JAX status server's
  payloads and error bodies; the fail-open surface (cancel, shed,
  supervised restart) behaves as in the JAX engine.
- The CLI parses every serving flag of a JAX command line with the JAX
  defaults, validates as the JAX CLI does (exit 2), builds the fleet and
  the status server the fleet and cache flags describe, and refuses only
  the replay flags and ``--outer_quant``.
"""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_tensorflow_example_tpu.models import transformer as jtfm
from distributed_tensorflow_example_tpu.serving import scheduler as jsched
from distributed_tensorflow_example_tpu.serving.engine import (
    DecodeEngine as JaxEngine)
from distributed_tensorflow_example_tpu_torch import config as tconfig
from distributed_tensorflow_example_tpu_torch import convert
from distributed_tensorflow_example_tpu_torch.models import transformer as ttfm
from distributed_tensorflow_example_tpu_torch.obs import slo as slo_lib
from distributed_tensorflow_example_tpu_torch.serving import cli as tcli
from distributed_tensorflow_example_tpu_torch.serving import kv_cache as tkvc
from distributed_tensorflow_example_tpu_torch.serving import scheduler as tsched
from distributed_tensorflow_example_tpu_torch.serving.admission import (
    ShedError, parse_brownout)
from distributed_tensorflow_example_tpu_torch.serving.engine import (
    DecodeEngine)
from distributed_tensorflow_example_tpu_torch.serving.faults import FaultPlan

_BASE = dict(input_size=32, num_classes=10, seq_len=32, d_model=32,
             n_heads=2, num_blocks=2, d_ff=64, objective="lm",
             vocab_size=50, causal=True)


def _models(**flags):
    kw = dict(_BASE, **flags)
    jspec = jtfm.TransformerSpec(**kw)
    tspec = ttfm.TransformerSpec(**kw)
    jp = jtfm.init(jax.random.PRNGKey(0), jspec)
    tp = convert.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                   tspec, device="cpu")
    return jspec, jp, tspec, tp


@pytest.fixture(scope="module")
def plain():
    """Both flags off, plus the JAX ``generate`` references of the
    six ragged prompts of tests/test_serving.py."""
    jspec, jp, tspec, tp = _models()
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, 50, size=n).tolist()
               for n in (3, 7, 5, 11, 2, 8)]
    n_new = 6
    gen = jax.jit(lambda p, x: jtfm.generate(jspec, p, x))
    refs = []
    for p in prompts:
        out = np.asarray(gen(jp, jnp.asarray([p], jnp.int32)))
        refs.append(out[0, len(p):len(p) + n_new].tolist())
    return tspec, tp, prompts, n_new, refs


@pytest.mark.parametrize("page_size", [4, 8, 16])
def test_engine_matches_jax_generate(plain, page_size):
    """Greedy completions through the port's engine (prefill -> paged
    cache -> continuous-batching decode) equal JAX ``generate``'s."""
    tspec, tp, prompts, n_new, refs = plain
    eng = DecodeEngine(tspec, tp, page_size=page_size, max_batch=3,
                       device="cpu")
    rids = [eng.submit(p, n_new) for p in prompts]
    assert eng.run_until_idle() > 0
    for rid, ref, p in zip(rids, refs, prompts):
        res = eng.result(rid, timeout=10.0)
        assert res["status"] == "result"
        assert res["tokens"] == ref
        assert res["prompt"] == p
        assert res["latency_ms"] >= res["ttft_ms"] >= 0.0


def test_fused_fp8_engine_matches_jax_engine():
    """fused_ln + fp8_ffn: the port's engine is token-identical to the
    JAX engine on the same requests, page size and max_batch, and both
    ran the same shape buckets (so the fp8 scales saw the same padded
    batches).  Prompts share one prefill bucket to keep the JAX side's
    interpret-mode compiles few."""
    jspec, jp, tspec, tp = _models(fused_ln=True, fp8_ffn=True)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, 50, size=n).tolist() for n in (5, 7, 6, 8)]
    jeng = JaxEngine(jspec, jp, page_size=8, max_batch=2)
    teng = DecodeEngine(tspec, tp, page_size=8, max_batch=2, device="cpu")
    jr = [jeng.submit(p, 5) for p in prompts]
    tr = [teng.submit(p, 5) for p in prompts]
    jeng.run_until_idle()
    teng.run_until_idle()
    assert [teng.result(r)["tokens"] for r in tr] == \
        [jeng.result(r)["tokens"] for r in jr]
    assert teng.shapes_used == jeng.shapes_used


def test_scheduler_copy_matches_jax_scheduler():
    """The port's copy of the pure-Python scheduler plans the same
    ticks as the JAX package's on one ragged request set."""
    reqs = [(i, 3 + 5 * i % 11, 2 + 3 * i % 7, float(i // 3))
            for i in range(12)]
    got = tsched.simulate(tsched.ContinuousScheduler(24, 4, 4), reqs)
    want = jsched.simulate(jsched.ContinuousScheduler(24, 4, 4), reqs)
    assert (got.decode_ticks, got.total_ticks, got.finish_ticks,
            got.shapes) == (want.decode_ticks, want.total_ticks,
                            want.finish_ticks, want.shapes)


def test_sample_tokens_greedy_rows_and_sampled_distribution():
    """Greedy rows take the argmax; sampled rows follow
    softmax(logits / t): over 4000 draws each category's frequency is
    within 0.03 of its probability (about 5 standard errors)."""
    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0]]).repeat(4000, 1)
    temp = torch.full((4000,), 0.7)
    temp[:10] = 0.0
    gen = torch.Generator().manual_seed(0)
    out = tkvc.sample_tokens(logits, gen, temp)
    assert torch.all(out[:10] == 0)
    freq = torch.bincount(out[10:], minlength=4).float() / 3990
    want = torch.softmax(logits[0] / 0.7, dim=-1)
    assert float((freq - want).abs().max()) < 0.03
    assert torch.equal(tkvc.sample_tokens(logits, None, temp),
                       torch.zeros(4000, dtype=torch.long))


def test_engine_fail_open_surface(plain):
    """Cancel -> typed timeout; a full queue sheds with a typed error;
    an injected crash under supervision re-queues and still completes
    every request with the unsupervised engine's greedy tokens."""
    tspec, tp, prompts, n_new, refs = plain
    eng = DecodeEngine(tspec, tp, page_size=4, max_batch=3, max_queue=2,
                       device="cpu")
    a = eng.submit(prompts[0], n_new)
    eng.submit(prompts[1], n_new)
    with pytest.raises(ShedError):
        eng.submit(prompts[2], n_new)
    assert eng.cancel(a)
    eng.run_until_idle()
    assert eng.result(a)["status"] == "timeout"
    assert eng.stats()["shed_total"] == 1

    sup = DecodeEngine(tspec, tp, page_size=4, max_batch=3,
                       engine_retries=2, device="cpu",
                       faults=FaultPlan(crash_at_ticks=(2,)))
    rids = [sup.submit(p, n_new) for p in prompts]
    sup.run_until_idle()
    assert [sup.result(r)["tokens"] for r in rids] == refs
    st = sup.stats()
    assert st["engine_restarts_total"] == 1 and st["requeued_total"] > 0


def test_engine_refuses_unported_arguments(plain, tmp_path):
    """No engine argument is refused any more: the restart narrator is
    taken (and kept for the supervised restarts); an unknown pool format
    raises as in JAX; no card means no default device."""
    from distributed_tensorflow_example_tpu_torch.resilience.restart import (
        RestartNarrator)

    tspec, tp = plain[:2]
    narr = RestartNarrator(str(tmp_path))
    assert DecodeEngine(tspec, tp, restart_narrator=narr,
                        device="cpu").restart_narrator is narr
    with pytest.raises(ValueError, match="int8"):
        DecodeEngine(tspec, tp, kv_quant="int4", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DecodeEngine(tspec, tp)


_CLI_FLAGS = ["--model=transformer", "--objective=lm", "--input_size=32",
              "--vocab_size=50", "--d_model=32", "--n_heads=2",
              "--num_blocks=2", "--d_ff=64", "--device=cpu"]


def _post(port, doc):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(doc).encode(),
        headers={"Content-Type": "application/json",
                 "traceparent": "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read()), resp.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


def test_http_generate_round_trip():
    """``POST /generate`` through the CLI's server (seeded demo init,
    fused_ln + fp8_ffn on the CPU): the JAX front door's response keys,
    the caller's trace id echoed, 400 on a bad body, /healthz up."""
    cfg = tconfig.parse_config(_CLI_FLAGS + ["--fused_ln", "--fp8_ffn"])
    server, engine = tcli.serve(cfg, 0)
    try:
        code, doc, headers = _post(server.port, {"prompt": [3, 1, 7],
                                                 "max_new_tokens": 4})
        assert code == 200, doc
        assert set(doc) == {"rid", "status", "prompt", "tokens",
                            "latency_ms", "ttft_ms", "trace_id"}
        assert doc["prompt"] == [3, 1, 7] and len(doc["tokens"]) == 4
        assert doc["trace_id"] == "ab" * 16
        assert headers["traceparent"].startswith("00-" + "ab" * 16)
        code, doc, _ = _post(server.port, {"prompt": "nope"})
        assert code == 400 and "prompt" in doc["error"]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/healthz", timeout=10) as r:
            health = json.loads(r.read())
        assert health["ok"] and health["serving"]["completed_total"] == 1
    finally:
        server.close()
        engine.stop()


@pytest.mark.parametrize("extra", [["--replay=w.json"],
                                   ["--replay_speed", "25"],
                                   ["--outer_quant=int8"]])
def test_cli_refuses_unported_flags(extra, capsys):
    assert tcli.main(_CLI_FLAGS + ["--serve_port=1"] + extra) == 2
    assert "ROADMAP" in capsys.readouterr().err


@pytest.mark.parametrize("extra", [["--trace_spans"],
                                   ["--slo=ttft_p99_ms<=250"],
                                   ["--kv_quant=int8"],
                                   ["--num_experts=4", "--moe_topk=2"],
                                   ["--trace_spans", "--span_keep", "5"],
                                   ["--trace_spans", "--span_rotate_mb",
                                    "1.5"],
                                   ["--replicas=2"], ["--breaker", "on"],
                                   ["--fleet_retries", "1"],
                                   ["--status_cache_s", "0"]])
def test_cli_accepts_the_ported_flags(extra, tmp_path):
    """The flags the port refused until a slice ported their feature: no
    refusal, the validation passes, and the engine they describe is built
    (int8 pools, a MoE spec, a recorder rotating as asked, the parsed
    SLOs); the fleet flags build the router they describe (the replicas,
    the breaker policy, the failover budget) and ``--status_cache_s``
    the status server's caches."""
    cfg = tconfig.parse_config(_CLI_FLAGS + ["--serve_port=1",
                                             f"--logs_path={tmp_path}"]
                               + extra)
    assert tcli.unported_flags(cfg) == []
    tconfig.validate_quant_config(cfg)
    tconfig.validate_serving_config(cfg)
    if cfg.replicas > 1 or cfg.breaker or cfg.fleet_retries != 2:
        from distributed_tensorflow_example_tpu_torch.serving import health

        router, engines = tcli.build_fleet(cfg)
        stats = router.stats()
        assert stats["replicas"] == cfg.replicas == len(engines)
        assert stats["fleet_retries"] == cfg.fleet_retries
        assert [r["breaker"]["state"] for r in stats["per_replica"]] == \
            ["closed"] * cfg.replicas
        assert router._replicas[0].breaker.policy.failures == \
            health.parse_breaker(cfg.breaker or "on").failures
        tcli.stop_engines(engines, router)
        return
    if cfg.status_cache_s != 15.0:
        server, engine = tcli.serve(cfg, 0)
        try:
            assert server._report_cache.ttl_s == cfg.status_cache_s
            assert server._fleet_cache.ttl_s == cfg.status_cache_s
            assert server.get_doc("/healthz")[0] == 200
        finally:
            server.close()
            tcli.stop_engines([engine])
        return
    eng = tcli.build_engine(cfg)
    assert eng.kv_quant == cfg.kv_quant
    assert eng.spec.num_experts == cfg.num_experts
    assert eng.spec.moe_topk == cfg.moe_topk
    assert [s.name for s in eng.slos] == \
        [s.name for s in slo_lib.parse_specs(cfg.slo)]
    assert (eng.recorder is not None) == cfg.trace_spans
    if eng.recorder is not None:
        assert eng.recorder.keep == cfg.span_keep
        assert eng.recorder.rotate_bytes == \
            int(cfg.span_rotate_mb * 1024 * 1024)
        eng.recorder.close()


# serving flags the port parses with the JAX defaults (the replay speed
# is refused when set; the rest are ported), so that a JAX dtx-serve
# command line reaches the port's handling, not argparse's error
_REFUSED_WITH_DEFAULTS = ("breaker", "fleet_retries", "replay_speed",
                          "span_keep", "span_rotate_mb", "status_cache_s")


def test_cli_refused_flags_parse_with_the_jax_defaults():
    from distributed_tensorflow_example_tpu import config as jconfig

    jax_args = vars(jconfig.build_parser().parse_args([]))
    ours = tconfig.parse_config([])
    for name in _REFUSED_WITH_DEFAULTS:
        assert getattr(ours, name) == jax_args[name], name
        assert type(getattr(ours, name)) is type(jax_args[name]), name
    assert tcli.unported_flags(ours) == []


def test_cli_needs_a_port_and_an_lm(capsys):
    assert tcli.main(_CLI_FLAGS) == 2
    assert tcli.main(["--serve_port=1", "--device=cpu"]) == 2
    assert parse_brownout("occ=0.5").occupancy_lo == round(0.5 * 5 / 6, 6)


# the serving flags of a JAX MoE + tracing dtx-serve command line
_JAX_SERVE_LINE = _CLI_FLAGS[:-1] + [
    "--serve_port=1", "--num_experts=4", "--moe_topk=2",
    "--moe_dispatch=alltoall", "--capacity_factor=2.0",
    "--moe_aux_weight=0.01", "--grouped_moe", "--num_classes=7",
    "--trace_spans", "--slo=ttft_p99_ms<=250,error_rate<=0.01",
    "--span_rotate_mb=2", "--span_keep=4", "--logs_path=/tmp/x",
    "--kv_quant=int8"]


def test_cli_moe_and_trace_flags_parse_as_in_jax():
    """The flags this slice added parse with JAX's defaults and types,
    a JAX MoE + tracing command line parses to the same values in both
    packages, and the port's spec carries every MoE field as JAX's
    ``_spec_from_cfg`` does."""
    from distributed_tensorflow_example_tpu import config as jconfig
    from distributed_tensorflow_example_tpu.serving import cli as jcli

    names = ("moe_topk", "moe_dispatch", "capacity_factor",
             "moe_aux_weight", "grouped_moe", "num_classes", "logs_path",
             "outer_quant", "kv_quant", "num_experts", "trace_spans", "slo",
             "span_rotate_mb", "span_keep")
    jax_args = vars(jconfig.build_parser().parse_args([]))
    ours = tconfig.parse_config([])
    for name in names:
        assert getattr(ours, name) == jax_args[name], name
        assert type(getattr(ours, name)) is type(jax_args[name]), name
    jcfg = jconfig.parse_config(_JAX_SERVE_LINE)
    tcfg = tconfig.parse_config(_JAX_SERVE_LINE + ["--device=cpu"])
    for name in names:
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    jspec, tspec = jcli._spec_from_cfg(jcfg), tcli.spec_from_cfg(tcfg)
    for f in ("num_classes", "num_experts", "moe_topk", "moe_dispatch",
              "capacity_factor", "aux_loss_weight", "grouped_moe",
              "fused_ln", "fp8_ffn", "seq_len", "attention"):
        assert getattr(tspec, f) == getattr(jspec, f), f
    assert tcli.unported_flags(tcfg) == []


@pytest.mark.parametrize("extra", [["--fp8_ffn", "--num_experts", "4"],
                                   ["--kv_quant=int8",
                                    "--objective=classify"],
                                   ["--slo=p99<=1"]])
def test_cli_validation_exits_2_in_both_packages(extra, capsys):
    """``--fp8_ffn`` with a dense-dispatch MoE, ``--kv_quant`` off the lm
    objective and a bad SLO spec: both CLIs exit 2 before building a
    model."""
    from distributed_tensorflow_example_tpu.serving import cli as jcli

    argv = _CLI_FLAGS[:-1] + ["--serve_port=1"] + extra
    assert jcli.main(argv) == 2
    assert tcli.main(argv + ["--device=cpu"]) == 2
    err = capsys.readouterr().err
    assert "ROADMAP" not in err


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_slo_trace_explain(tmp_path):
    """``--trace_spans --slo``: after one POST /generate, /slo is the
    evaluated document of the parsed specs, /trace?rid=0 the request's
    reconstructed record and rows, /explain its waterfall tiling the
    wall; the 400 and 404 bodies are the JAX status server's; /metrics
    carries the SLO and waterfall gauges; an unknown path's 404 names the
    endpoints; every span row validates."""
    from distributed_tensorflow_example_tpu_torch.obs import schema

    cfg = tconfig.parse_config(_CLI_FLAGS + [
        "--trace_spans", "--slo=ttft_p99_ms<=60000,error_rate<=0.01",
        f"--logs_path={tmp_path}"])
    server, engine = tcli.serve(cfg, 0)
    try:
        port = server.port
        code, doc, _ = _post(port, {"prompt": [3, 1, 7],
                                    "max_new_tokens": 4})
        assert code == 200, doc
        # the retire lands at the engine's next boundary
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            code, tr = _get(port, "/trace?rid=0")
            if code == 200 and tr["record"].get("terminal") == "result":
                break
            time.sleep(0.05)
        rec = tr["record"]
        assert rec["complete"] and rec["trace_id"] == "ab" * 16
        assert {e["event"] for e in tr["events"]} >= {
            "submit", "admit", "prefill", "first_token", "tick", "retire"}
        code, slo = _get(port, "/slo")
        assert code == 200 and slo["kind"] == "slo_report"
        assert [s["name"] for s in slo["slos"]] == ["ttft_p99_ms",
                                                    "error_rate"]
        assert slo["requests"] == 1 and slo["ok"]
        code, ex = _get(port, "/explain?rid=0")
        assert code == 200 and len(ex["waterfalls"]) == 1
        wf = ex["waterfalls"][0]
        assert wf["complete"] and wf["terminal"] == "result"
        assert wf["segment_sum_ms"] >= 0.99 * wf["wall_ms"]
        assert ex["summary"]["sum_to_wall_ok"]
        code, ex = _get(port, "/explain?trace=" + "ab" * 16)
        assert code == 200 and [w["rid"] for w in ex["waterfalls"]] == [0]
        assert _get(port, "/trace") == (
            400, {"error": "/trace needs ?rid=N (an integer request id)"})
        assert _get(port, "/trace?rid=x")[0] == 400
        assert _get(port, "/trace?rid=99") == (
            404, {"error": "rid 99 not in the span stream tails"})
        assert _get(port, "/explain?rid=x") == (
            400, {"error": "?rid=N must be an integer"})
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=30) as r:
            text = r.read().decode()
        assert "dtx_slo_requests 1" in text
        assert "dtx_waterfall_requests 1" in text
        code, doc = _get(port, "/nope")
        assert code == 404 and doc["endpoints"] == [
            "/status", "/metrics", "/report", "/slo", "/trace", "/fleet",
            "/explain", "/generate", "/healthz"]
    finally:
        server.close()
        engine.stop()
        engine.recorder.close()
    assert schema.validate_span_file(engine.recorder.path) == []


def test_chip_smoke_serving_phases_rehearse_on_cpu():
    """``chip_smoke.py``'s serving and HTTP phases, rehearsed on the CPU
    at a narrow width: the same engine calls, result checks and the
    card-vs-CPU logits comparison (here CPU vs CPU: exact), with the
    kernel counters at 0 because CPU tensors take the plain versions."""
    import chip_smoke

    narrow = dict(chip_smoke.FULL_WIDTH, input_size=128, seq_len=128,
                  d_model=32, n_heads=2, num_blocks=2, d_ff=64)
    run = chip_smoke.phase_serve("cpu", device="cpu", width=narrow)
    assert set(run["counts"].values()) == {0}
    flags = [f for f in chip_smoke.FULL_WIDTH_FLAGS
             if not f.startswith(("--input_size", "--d_model", "--n_heads",
                                  "--d_ff"))]
    chip_smoke.phase_http(flags + ["--input_size=128", "--d_model=32",
                                   "--n_heads=2", "--d_ff=64",
                                   "--device=cpu"])


def test_chip_smoke_int8_moe_and_traced_phases_rehearse_on_cpu():
    """The phases this slice added to ``chip_smoke.py``, rehearsed on
    the CPU at a narrow width: the int8 serve beside the bf16 pool's
    (the pool's bytes at (Dh + 4) / (2 Dh) of it, the chained decode
    step within its bound), the MoE serve (E 4, its routing and prefill
    held CPU vs CPU: no flip, exact), the traced HTTP serve and the
    trace-overhead rounds."""
    import chip_smoke

    narrow = dict(chip_smoke.FULL_WIDTH, input_size=128, seq_len=128,
                  d_model=32, n_heads=2, num_blocks=2, d_ff=64)
    run = chip_smoke.phase_serve("cpu", device="cpu", width=narrow)
    int8 = chip_smoke.phase_serve_int8("cpu", run, device="cpu")
    dh = narrow["d_model"] // narrow["n_heads"]
    assert int8["pool_ratio"] == pytest.approx((dh + 4) / (2 * dh))
    assert int8["decode_err"] <= chip_smoke.INT8_DECODE_ATOL
    moe = chip_smoke.phase_serve_moe(
        "cpu", device="cpu",
        width=dict(chip_smoke.MOE_SERVE, input_size=128, seq_len=128,
                   d_model=32, n_heads=2, d_ff=64, num_experts=4))
    assert moe["flips"] == 0 and set(moe["counts"].values()) == {0}
    flags = [f for f in chip_smoke.FULL_WIDTH_FLAGS
             if not f.startswith(("--input_size", "--d_model", "--n_heads",
                                  "--d_ff"))]
    traced = chip_smoke.phase_http_traced(
        flags + ["--input_size=128", "--d_model=32", "--n_heads=2",
                 "--d_ff=64", "--device=cpu"])
    assert traced["frac"] >= chip_smoke.WATERFALL_MIN_FRAC
    trace = chip_smoke.phase_trace_overhead("cpu", run, rounds=1,
                                            device="cpu")
    assert trace["ratio"] > 0 and trace["rows"] >= 2


def test_chip_smoke_status_fleet_and_chaos_phases_rehearse_on_cpu():
    """``chip_smoke.py``'s phases 4d-4f rehearsed on the CPU at a narrow
    width: the status server's /status, /metrics, /report and /fleet
    after one POST with the narrator armed; 8 concurrent POSTs to one
    engine and to a two-replica fleet (the fleet report exactly-once,
    the router over one replica bitwise invisible); three replicas under
    the crash plan (a failover, clean chains, valid restarts.jsonl).
    The counters stay 0: CPU tensors take the plain versions."""
    import chip_smoke

    narrow = dict(chip_smoke.FULL_WIDTH, input_size=128, seq_len=128,
                  d_model=32, n_heads=2, num_blocks=2, d_ff=64)
    run = chip_smoke.phase_serve("cpu", device="cpu", width=narrow)
    flags = [f for f in chip_smoke.FULL_WIDTH_FLAGS
             if not f.startswith(("--input_size", "--d_model", "--n_heads",
                                  "--d_ff"))]
    flags += ["--input_size=128", "--d_model=32", "--n_heads=2",
              "--d_ff=64", "--device=cpu"]
    assert chip_smoke.phase_status(flags)["gauges"] > 0
    fleet = chip_smoke.phase_fleet("cpu", run, flags, device="cpu")
    assert set(fleet["counts"].values()) == {0}
    assert fleet["tps"] > 0 and fleet["one_tps"] > 0
    chaos = chip_smoke.phase_chaos("cpu", run, device="cpu")
    assert chaos["moved"] >= 1 and chaos["restarts"] >= 1
