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
  HTTP front door answers ``POST /generate``; the fail-open surface
  (cancel, shed, supervised restart) behaves as in the JAX engine.
"""

import json
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


def test_engine_refuses_unported_arguments(plain):
    tspec, tp = plain[:2]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DecodeEngine(tspec, tp, recorder=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DecodeEngine(tspec, tp, kv_quant="int8", device="cpu")
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


@pytest.mark.parametrize("extra", [["--replicas=2"], ["--replay=w.json"],
                                   ["--trace_spans"], ["--slo=x"],
                                   ["--kv_quant=int8"],
                                   ["--breaker", "on"],
                                   ["--fleet_retries", "1"],
                                   ["--replay_speed", "25"],
                                   ["--span_keep", "5"],
                                   ["--span_rotate_mb", "1.5"],
                                   ["--status_cache_s", "0"]])
def test_cli_refuses_unported_flags(extra, capsys):
    assert tcli.main(_CLI_FLAGS + ["--serve_port=1"] + extra) == 2
    assert "ROADMAP" in capsys.readouterr().err


# serving flags of features the port refuses when set: parsed, so that a
# JAX dtx-serve command line reaches the refusal, not argparse's error
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


def test_chip_smoke_serving_phases_rehearse_on_cpu():
    """``chip_smoke.py``'s serving and HTTP phases, rehearsed on the CPU
    at a narrow width: the same engine calls, result checks and the
    card-vs-CPU logits comparison (here CPU vs CPU: exact), with the
    kernel counters at 0 because CPU tensors take the plain versions."""
    import chip_smoke

    narrow = dict(chip_smoke.FULL_WIDTH, input_size=128, seq_len=128,
                  d_model=32, n_heads=2, num_blocks=2, d_ff=64)
    counts = chip_smoke.phase_serve("cpu", device="cpu", width=narrow)
    assert set(counts.values()) == {0}
    flags = [f for f in chip_smoke.FULL_WIDTH_FLAGS
             if not f.startswith(("--input_size", "--d_model", "--n_heads",
                                  "--d_ff"))]
    chip_smoke.phase_http(flags + ["--input_size=128", "--d_model=32",
                                   "--n_heads=2", "--d_ff=64",
                                   "--device=cpu"])
