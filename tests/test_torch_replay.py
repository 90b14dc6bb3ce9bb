"""The port's workload replay (``obs/workload.py``,
``serving/replay.py``, ``dtx-serve --replay``) against the JAX package's,
on the CPU.

- The workload documents are the same bytes: ``synth_prompt``,
  ``workload_id`` and ``synthetic_workload`` equal JAX's; a file either
  package writes loads in the other; ``capture`` of one span directory
  gives the same document in both packages, and a ``replay_sim`` stream
  re-captures to its input's ``workload_id``.
- ``replay_sim`` reports equal JAX's exactly (the same scheduler over
  the same ticks-as-seconds clock).
- ``replay_engine`` over a tiny port engine and a tiny JAX engine with
  the same params, both under a virtual clock: identical terminals,
  token counts and token signatures (f32, greedy: exact); ``identity``
  holds across two port replays.
- ``dtx-serve --replay`` in both packages, one engine and
  ``--replicas 2``: the same report keys, exit 0, stdout nothing but the
  report; the span stream names the workload and re-captures to its
  schedule (the shapes in arrival order; the arrivals are the wall
  clock's, so only ``replay_sim`` round-trips the id itself); an
  unreadable workload exits 2 in both.
"""

import io
import json
import contextlib
import os

import jax
import numpy as np
import pytest

from distributed_tensorflow_example_tpu.models import transformer as jtfm
from distributed_tensorflow_example_tpu.obs import spans as jspans
from distributed_tensorflow_example_tpu.obs import workload as jwl
from distributed_tensorflow_example_tpu.serving import cli as jcli
from distributed_tensorflow_example_tpu.serving import replay as jrp
from distributed_tensorflow_example_tpu.serving.engine import (
    DecodeEngine as JaxEngine)
from distributed_tensorflow_example_tpu_torch import convert
from distributed_tensorflow_example_tpu_torch.models import transformer as ttfm
from distributed_tensorflow_example_tpu_torch.obs import schema as tschema
from distributed_tensorflow_example_tpu_torch.obs import spans as tspans
from distributed_tensorflow_example_tpu_torch.obs import workload as twl
from distributed_tensorflow_example_tpu_torch.serving import cli as tcli
from distributed_tensorflow_example_tpu_torch.serving import replay as trp
from distributed_tensorflow_example_tpu_torch.serving.engine import (
    DecodeEngine)

# name: synthetic_workload keywords
WORKLOADS = {
    "plain": dict(n=12, seed=3),
    "deadlines": dict(n=10, seed=5, qps=4.0, deadline_ms=1500.0),
    "no_sharing": dict(n=8, seed=7, shared_prefix_frac=0.0, mean_new=30),
}


def _strip_t(doc):
    return {k: v for k, v in doc.items() if k != "generated_t"}


def test_synth_prompt_and_workload_id_match_jax():
    rng = np.random.RandomState(0)
    for n in (1, 15, 16, 17, 40):
        toks = rng.randint(1, 64, size=n).tolist()
        fp = twl.prompt_fingerprint(toks)
        assert fp == jwl.prompt_fingerprint(toks)
        for fpr in (fp, None, fp[:1]):
            assert twl.synth_prompt(n, fpr, 64, seed=2, rid=4) == \
                jwl.synth_prompt(n, fpr, 64, seed=2, rid=4)
    for kw in WORKLOADS.values():
        doc = twl.synthetic_workload(**kw)
        assert doc == jwl.synthetic_workload(**kw)
        assert twl.workload_id(doc["requests"]) == \
            jwl.workload_id(doc["requests"]) == doc["workload_id"]
        assert tschema.validate_workload(doc) == []


def test_workload_files_load_across_packages(tmp_path):
    """A workload either package writes loads in the other, bytes and
    id unchanged; both refuse the same malformed document."""
    doc = twl.synthetic_workload(**WORKLOADS["deadlines"])
    twl.write_workload(doc, str(tmp_path / "t.json"))
    jwl.write_workload(doc, str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()
    assert jwl.load_workload(str(tmp_path / "t.json")) == doc
    assert twl.load_workload(str(tmp_path / "j.json")) == doc
    bad = dict(doc, requests=list(reversed(doc["requests"])))
    twl.write_workload(bad, str(tmp_path / "bad.json"))
    for load in (twl.load_workload, jwl.load_workload):
        with pytest.raises(ValueError, match="rid"):
            load(str(tmp_path / "bad.json"))


@pytest.mark.parametrize("speed", [1.0, 4.0])
@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_replay_sim_matches_jax(name, speed):
    doc = twl.synthetic_workload(**WORKLOADS[name])
    for pool in (dict(), dict(num_pages=33, page_size=8, max_batch=2)):
        got = trp.replay_sim(doc, speed=speed, **pool)
        assert got == jrp.replay_sim(doc, speed=speed, **pool)
        assert got["n_requests"] == doc["n_requests"]
    assert trp.identity(got, trp.replay_sim(doc, speed=speed,
                                            **pool))["identical"]


def test_capture_matches_jax_and_round_trips(tmp_path):
    """One replay_sim span stream per package, each captured by both:
    four equal documents (bar the capture time and the directory named
    as the source) whose id is the input's; the streams carry
    ``replay_of``."""
    doc = twl.synthetic_workload(**WORKLOADS["deadlines"])
    dirs = {}
    for side, rp, spans in (("torch", trp, tspans), ("jax", jrp, jspans)):
        d = str(tmp_path / side)
        rec = rp.replay_recorder(d, doc["workload_id"])
        rp.replay_sim(doc, recorder=rec)
        rec.close()
        rows = spans.load_spans(d)
        assert rows and all(r["replay_of"] == doc["workload_id"]
                            for r in rows)
        dirs[side] = d
    caps = {(side, who): _strip_t(cap(d))
            for side, d in dirs.items()
            for who, cap in (("torch", twl.capture), ("jax", jwl.capture))}
    for side in dirs:
        assert caps[(side, "torch")] == caps[(side, "jax")]
    assert {c["workload_id"] for c in caps.values()} == {doc["workload_id"]}
    assert caps[("torch", "torch")]["requests"] == \
        caps[("jax", "jax")]["requests"]


class _Clock:
    """A virtual clock: ``sleep`` advances it (no real waiting)."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, dt):
        self.t += dt


_SPEC = dict(input_size=64, num_classes=10, seq_len=64, d_model=32,
             n_heads=2, num_blocks=2, d_ff=64, objective="lm",
             vocab_size=64, causal=True)


@pytest.fixture(scope="module")
def engines():
    jspec = jtfm.TransformerSpec(**_SPEC)
    tspec = ttfm.TransformerSpec(**_SPEC)
    jp = jtfm.init(jax.random.PRNGKey(0), jspec)
    tp = convert.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                   tspec, device="cpu")
    return jspec, jp, tspec, tp


def _replay(make_engine, rp, doc):
    eng = make_engine()
    eng.start()
    clock = _Clock()
    try:
        return rp.replay_engine(eng, doc, vocab_size=64, speed=2.0,
                                clock=clock, sleep=clock.sleep)
    finally:
        eng.stop()


def test_replay_engine_matches_jax_under_a_virtual_clock(engines):
    """The same workload through a port engine and a JAX engine over the
    same params, greedy f32, arrivals on a virtual clock: every
    request's terminal, token count and token signature equal (exact);
    two port replays are identical."""
    jspec, jp, tspec, tp = engines
    doc = twl.synthetic_workload(n=6, seed=11, mean_prompt=10, mean_new=5)
    port = [_replay(lambda: DecodeEngine(tspec, tp, page_size=8,
                                         max_batch=4, seed=0,
                                         device="cpu"), trp, doc)
            for _ in range(2)]
    ref = _replay(lambda: JaxEngine(jspec, jp, page_size=8, max_batch=4,
                                    seed=0), jrp, doc)
    assert port[0]["terminals"] == ref["terminals"] == {"result": 6}
    assert port[0]["per_request"] == ref["per_request"]
    assert port[0]["tokens_total"] == ref["tokens_total"]
    assert set(port[0]) == set(ref)
    verdict = trp.identity(port[0], port[1])
    assert verdict["identical"] and verdict["determinism_frac"] == 1.0
    assert trp.identity(port[0], ref) == jrp.identity(port[0], ref)


_CLI = ["--model=transformer", "--objective=lm", "--input_size=32",
        "--vocab_size=50", "--d_model=32", "--n_heads=2", "--num_blocks=2",
        "--d_ff=64", "--decode_max_batch=4", "--decode_page_size=8",
        "--seed=0"]


def _cli(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("replicas", [1, 2])
def test_cli_replay_in_both_packages(tmp_path, replicas):
    """``dtx-serve --replay`` at a tiny configuration in both packages:
    exit 0, stdout exactly the report JSON with the same keys and
    terminals; under ``--trace_spans`` the port's stream names the
    workload and re-captures to its schedule."""
    doc = twl.synthetic_workload(n=6, seed=2, mean_prompt=8, mean_new=4,
                                 vocab_size=50, qps=200.0)
    path = str(tmp_path / "wl.json")
    twl.write_workload(doc, path)
    reps = {}
    for side, main, extra in (("torch", tcli.main, ["--device=cpu"]),
                              ("jax", jcli.main, [])):
        logs = str(tmp_path / side)
        rc, out = _cli(main, _CLI + extra + [
            f"--replay={path}", "--replay_speed=20", "--trace_spans",
            f"--replicas={replicas}", f"--logs_path={logs}"])
        assert rc == 0, out
        reps[side] = json.loads(out)
    t, j = reps["torch"], reps["jax"]
    assert set(t) == set(j) and t["mode"] == j["mode"] == "engine"
    assert t["terminals"] == j["terminals"] == {"result": 6}
    assert t["workload_id"] == doc["workload_id"]
    assert [r["tokens"] for r in t["per_request"]] == \
        [r["tokens"] for r in j["per_request"]]
    logs = str(tmp_path / "torch")
    if replicas > 1:
        assert sorted(os.listdir(logs)) == ["replica0", "replica1",
                                            "router"]
    rows = [r for d, _s, fs in os.walk(logs) for f in fs
            if f.startswith("spans.")
            for r in tspans.read_spans(os.path.join(d, f))]
    assert rows and {r["replay_of"] for r in rows} == {doc["workload_id"]}
    # the re-capture keeps the schedule's shapes: one engine in arrival
    # order with the recorded fingerprints, a fleet (whose sources the
    # collector aligns on their wall clocks) as a multiset; its arrivals
    # are the wall clock's, so its id is not the input's, in either
    # package
    def shapes(d):
        key = ("prompt_len", "max_new_tokens")
        if replicas == 1:
            return [[r[k] for k in key + ("fingerprint",)]
                    for r in d["requests"]]
        return sorted([r[k] for k in key] for r in d["requests"])

    cap = twl.capture(logs)
    assert shapes(cap) == shapes(doc)
    assert shapes(jwl.capture(str(tmp_path / "jax"))) == shapes(cap)


def test_cli_replay_refuses_an_unreadable_workload(tmp_path, capsys):
    (tmp_path / "bad.json").write_text('{"kind": "workload"}')
    for main, extra in ((tcli.main, ["--device=cpu"]), (jcli.main, [])):
        assert main(_CLI + extra + [
            f"--replay={tmp_path / 'bad.json'}"]) == 2
        assert "--replay" in capsys.readouterr().err
