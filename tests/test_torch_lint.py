"""The port's dtx-lint (``distributed_tensorflow_example_tpu_torch/
analysis``) — pure python, stdlib + ast only, like the JAX package's.

- each torch-form rule (``axis-consistency`` over process groups,
  ``host-sync`` over the port's step window, ``autograd-complete``,
  ``recapture``, ``nondet``) on its own bad, good and edge fixtures,
  mirroring ``tests/test_lint.py`` where the rule is the same check;
- the shared-form rules and the machinery (``schema-drift``,
  ``flag-drift``, ``gauge-drift``, ``scope-registry``, noqa,
  ``parse-error``, the baseline, the CLI's exit codes and ``--json``
  document) run through JAX's ``analysis.cli`` and the port's on one
  fixture tree, with equal ``(rule, file, line, msg)`` lists and codes;
- the whole port lints clean against its baseline, with every rule
  active on it.
"""

import ast
import json
import os
import re
import textwrap

import pytest

from distributed_tensorflow_example_tpu.analysis import cli as jcli
from distributed_tensorflow_example_tpu.analysis import findings as jfind
from distributed_tensorflow_example_tpu_torch.analysis import cli as tcli
from distributed_tensorflow_example_tpu_torch.analysis import findings as tfind
from distributed_tensorflow_example_tpu_torch.analysis import rules_spmd
from distributed_tensorflow_example_tpu_torch.analysis.index import (
    ModuleIndex)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "distributed_tensorflow_example_tpu_torch")


def make_tree(tmp_path, files, root_files=None):
    """A fixture package at tmp_path/pkg (plus repo-root files such as
    docs/API.md or README.md beside it); returns its path."""
    pkg = tmp_path / "pkg"
    pkg.mkdir(exist_ok=True)
    for rel, src in files.items():
        p = pkg / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    for rel, src in (root_files or {}).items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return str(pkg)


def lint(tmp_path, files, root_files=None, rules=None):
    root = make_tree(tmp_path, files, root_files)
    _index, _ctx, kept, suppressed = tcli.run_lint(root, rules)
    return kept, suppressed


def rules_of(found):
    return [f.rule for f in found]


def rows(found):
    return [(f.rule, f.file, f.line, f.msg) for f in found]


def both(tmp_path, files, root_files=None, rules=None):
    """JAX's and the port's findings (kept, suppressed) on one tree,
    asserted equal; returns the port's."""
    root = make_tree(tmp_path, files, root_files)
    _i, _c, jkept, jsupp = jcli.run_lint(root, rules)
    _i, _c, tkept, tsupp = tcli.run_lint(root, rules)
    assert rows(tkept) == rows(jkept)
    assert rows(tsupp) == rows(jsupp)
    return tkept, tsupp


# ------------------------------------------- rule 1: process groups

MESH = """
    import dataclasses

    @dataclasses.dataclass
    class Mesh:
        dp: int
        data_group: object = None
        model_group: object = None

        @property
        def batch_group(self):
            return self.data_group

    @dataclasses.dataclass
    class SeqAxis:
        size: int
        group: object = None
"""

GROUP_BAD = """
    import torch.distributed as dist

    def reduce(x, mesh, other):
        dist.all_reduce(x, group=mesh.dtaa_group)
        dist.all_reduce(x, group=other)
"""

GROUP_GOOD = """
    import torch.distributed as dist
    from . import cluster

    def reduce(x, out, mesh, axis, group, model_group):
        g = mesh.model_group
        dist.all_reduce(x, group=mesh.data_group)
        dist.all_reduce(x, group=mesh.batch_group)
        dist.all_to_all_single(out, x, group=axis.group)
        dist.all_reduce(x, group=g)
        dist.all_reduce(x, None, group)
        dist.broadcast(x, 0, group=model_group)
        ops = [dist.P2POp(dist.isend, x, 1, group=axis.group)]
        dist.batch_isend_irecv(ops)
        cluster.all_gather_flat(out, x, group=mesh.data_group)
"""


def test_axis_consistency_bad(tmp_path):
    found, _ = lint(tmp_path, {"mesh.py": MESH, "step.py": GROUP_BAD},
                    rules=["axis-consistency"])
    assert rules_of(found) == ["axis-consistency"] * 2
    assert "'mesh.dtaa_group'" in found[0].msg
    assert "'other'" in found[1].msg


def test_axis_consistency_good(tmp_path):
    found, _ = lint(tmp_path, {"mesh.py": MESH, "step.py": GROUP_GOOD},
                    rules=["axis-consistency"])
    assert found == []


@pytest.mark.parametrize("call", [
    "dist.all_reduce(x)", "dist.barrier()",
    "dist.reduce_scatter_tensor(x, x)", "cluster.reduce_scatter_flat(x, x)",
    "dist.all_reduce(x, group=None)", "torch.distributed.all_gather(x, x)"])
def test_axis_consistency_world_collective(tmp_path, call):
    """No group= (or group=None) runs over the world: a finding."""
    src = f"""
        import torch
        import torch.distributed as dist
        from . import cluster

        def f(x):
            {call}
    """
    found, _ = lint(tmp_path, {"mesh.py": MESH, "step.py": src},
                    rules=["axis-consistency"])
    assert rules_of(found) == ["axis-consistency"]
    assert "world" in found[0].msg


def test_axis_consistency_sees_function_local_imports(tmp_path):
    src = """
        def f(x):
            import torch.distributed as d
            from torch import distributed

            d.barrier()
            distributed.all_reduce(x)
    """
    found, _ = lint(tmp_path, {"mesh.py": MESH, "step.py": src},
                    rules=["axis-consistency"])
    assert rules_of(found) == ["axis-consistency"] * 2


def test_axis_consistency_local_from_unknown_is_a_finding(tmp_path):
    # a local is followed to what it was assigned from
    src = """
        import torch.distributed as dist

        def f(x, mesh):
            g = mesh.no_such
            dist.all_reduce(x, group=g)
    """
    found, _ = lint(tmp_path, {"mesh.py": MESH, "step.py": src},
                    rules=["axis-consistency"])
    assert rules_of(found) == ["axis-consistency"]
    assert "'mesh.no_such'" in found[0].msg


def test_axis_consistency_inactive_without_mesh(tmp_path):
    found, _ = lint(tmp_path, {"step.py": GROUP_BAD},
                    rules=["axis-consistency"])
    assert found == []


# ------------------------------------------------- rule 2: host-sync

LOOP_BAD = """
    def run(feed, timed_batches, step):
        for i, batch in timed_batches(feed):
            cost_dev = step(batch)
            cost = float(cost_dev)
"""

LOOP_GOOD = """
    def run(feed, tracer, timed_batches, step):
        inflight = []
        for i, batch in timed_batches(feed):
            cost_dev = step(batch)
            with tracer.annotate("device_wait"):
                cost = float(cost_dev)
                inflight.pop(0).synchronize()
"""


def test_host_sync_bad(tmp_path):
    found, _ = lint(tmp_path, {"train/loop.py": LOOP_BAD},
                    rules=["host-sync"])
    assert rules_of(found) == ["host-sync"]
    assert "float(<device value>)" in found[0].msg


def test_host_sync_sanctioned_by_annotate(tmp_path):
    found, _ = lint(tmp_path, {"train/loop.py": LOOP_GOOD},
                    rules=["host-sync"])
    assert found == []


@pytest.mark.parametrize("stmt,what", [
    ("x = cost_dev.item()", ".item()"),
    ("x = cost_dev.cpu()", ".cpu()"),
    ("x = batch.numpy()", ".numpy()"),
    ('x = cost_dev.to("cpu")', '.to("cpu")'),
    ("torch.cuda.synchronize()", "torch.cuda.synchronize()"),
    ("torch.cuda.synchronize(dev)", "torch.cuda.synchronize()"),
    ("inflight[0].synchronize()", ".synchronize()"),
    ("x = extra[-1].tolist()", ".tolist() of a device value"),
    ("x = bool(extra[-1])", "bool(<device value>)"),
    ("x = int(anom_pending[0])", "int(<device value>)"),
    ("print(cost_dev)", "print(<device value>)"),
    ("x = np.asarray(norms_dev)", "np.asarray(<device value>)")])
def test_host_sync_constructs(tmp_path, stmt, what):
    src = f"""
        import numpy as np
        import torch

        def run(feed, timed_batches, step, dev):
            inflight = []
            for i, batch in timed_batches(feed):
                cost_dev, extra = step(batch)
                norms_dev = anom_pending = extra
                {stmt}
    """
    found, _ = lint(tmp_path, {"train/loop.py": src}, rules=["host-sync"])
    assert rules_of(found) == ["host-sync"]
    assert found[0].msg.startswith(what)


def test_host_sync_transitive_callee(tmp_path):
    # the hot region includes module-local functions the loop calls
    src = """
        def drain(inflight):
            inflight.pop(0).synchronize()

        def run(feed, timed_batches, step):
            inflight = []
            for i, batch in timed_batches(feed):
                inflight.append(step(batch))
                drain(inflight)
    """
    found, _ = lint(tmp_path, {"train/loop.py": src}, rules=["host-sync"])
    assert rules_of(found) == ["host-sync"]
    assert ".synchronize()" in found[0].msg


def test_host_sync_callee_of_a_sanctioned_site_is_inside_it(tmp_path):
    # the loop's fetch helper runs inside the annotate that calls it
    src = """
        def _fetch(*tensors):
            return [t.cpu().numpy() for t in tensors]

        def run(feed, tracer, timed_batches, step):
            for i, batch in timed_batches(feed):
                cost_dev = step(batch)
                with tracer.annotate("device_wait"):
                    cost, = _fetch(cost_dev)
    """
    found, _ = lint(tmp_path, {"train/loop.py": src}, rules=["host-sync"])
    assert found == []


def test_host_sync_outside_window_ok(tmp_path):
    src = """
        def run(feed, timed_batches, step, warm_dev):
            x = float(warm_dev)
            for i, batch in timed_batches(feed):
                step(batch)
            return warm_dev.item()
    """
    found, _ = lint(tmp_path, {"train/loop.py": src}, rules=["host-sync"])
    assert found == []


# --------------------------------------------- rule 3: schema-drift

SCHEMA_BAD = {
    "obs/schema.py": """
        METRICS_COMMON = {"v": (int,), "ghost_field": (int,)}
    """,
    "obs/metrics.py": """
        def row():
            return {"v": 3}
    """,
}

SCHEMA_GOOD = {
    "obs/schema.py": """
        METRICS_COMMON = {"v": (int,), "cost": (float,)}
    """,
    "obs/metrics.py": """
        def row(cost):
            return {"v": 3, "cost": cost}
    """,
}


def test_schema_drift_bad_as_jax(tmp_path):
    found, _ = both(tmp_path, SCHEMA_BAD, rules=["schema-drift"])
    assert rules_of(found) == ["schema-drift"]
    assert "'ghost_field'" in found[0].msg


def test_schema_drift_good_as_jax(tmp_path):
    found, _ = both(tmp_path, SCHEMA_GOOD, rules=["schema-drift"])
    assert found == []


def test_schema_drift_bucket_expansion_as_jax(tmp_path):
    files = {
        "obs/buckets.py": 'WINDOW_BUCKETS = ("data_wait",)\n'
                          'HOST_BUCKET = "host"\n',
        "obs/schema.py": """
            METRICS_WINDOW = {"data_wait_s": (float,), "host_s": (float,),
                              "h2d_s": (float,)}
        """,
        "obs/metrics.py": """
            from .buckets import HOST_BUCKET, WINDOW_BUCKETS
        """,
    }
    found, _ = both(tmp_path, files, rules=["schema-drift"])
    assert rules_of(found) == ["schema-drift"]
    assert "'h2d_s'" in found[0].msg


def test_schema_version_bump_undocumented_as_jax(tmp_path):
    files = {"obs/schema.py": """
        SCHEMA_VERSION = 3
        METRICS_COMMON = {"v": (int,)}
    """}
    root_files = {"docs/observability.md": "# obs\n\nnothing versioned\n",
                  "docs/API.md": "# api\n"}
    found, _ = both(tmp_path, files, root_files, rules=["schema-drift"])
    msgs = [f.msg for f in found]
    assert any("history comment never mentions v3" in m for m in msgs)
    assert any("docs/observability.md never mentions v3" in m
               for m in msgs)
    assert any("CONTRACT_WRITERS was never revisited for v3" in m
               for m in msgs)


def test_schema_version_bump_documented_as_jax(tmp_path):
    files = {"obs/schema.py": """
        SCHEMA_VERSION = 10
        # v10 = WORKLOAD capture/replay documents
        METRICS_COMMON = {"v": (int,)}
    """}
    root_files = {"docs/observability.md": "# obs\n\nschema v10\n",
                  "docs/API.md": "# api\n"}
    found, _ = both(tmp_path, files, root_files, rules=["schema-drift"])
    assert found == []


def test_schema_drift_gate_needs_the_ports_own_bench(tmp_path):
    """The gate is idle without a bench in the linted tree (the
    repo-root bench.py is JAX's, and the port does not read it); a
    bench of the port's own makes it a producer."""
    compare = """
        GATE_METRICS = {"step_ms": (True, 0.1), "gone_ms": (True, 0.1)}
    """
    root_bench = {"bench.py": 'def row():\n    return {"step_ms": 1.0}\n'}
    found, _ = lint(tmp_path, {"obs/compare.py": compare}, root_bench,
                    rules=["schema-drift"])
    assert found == []
    (tmp_path / "pkg" / "bench.py").write_text(root_bench["bench.py"])
    found, _ = lint(tmp_path, {"obs/compare.py": compare},
                    rules=["schema-drift"])
    assert rules_of(found) == ["schema-drift"]
    assert "'gone_ms'" in found[0].msg


# ------------------------------------ rule 4: autograd-complete

FN_GOOD = """
    import torch

    class Mul(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, y, scale):
            ctx.save_for_backward(x, y)
            ctx.scale = scale
            return x * y * scale

        @staticmethod
        def backward(ctx, g):
            x, y = ctx.saved_tensors
            if g is None:
                return None, None, None
            return g * y * ctx.scale, g * x * ctx.scale, None
"""


def test_autograd_complete_good(tmp_path):
    found, _ = lint(tmp_path, {"ops.py": FN_GOOD},
                    rules=["autograd-complete"])
    assert found == []


@pytest.mark.parametrize("edit,want", [
    (("    @staticmethod\n    def backward", "    def backward"),
     "backward is not a @staticmethod"),
    (("return g * y * ctx.scale, g * x * ctx.scale, None",
      "return g * y * ctx.scale, g * x * ctx.scale"),
     "backward returns 2 gradients; forward takes 3 inputs"),
    (("x, y = ctx.saved_tensors", "x, y = g, g"),
     "never reads ctx.saved_tensors"),
    (("def backward(ctx, g):", "def backwards(ctx, g):"),
     "has no backward")])
def test_autograd_complete_bad(tmp_path, edit, want):
    src = textwrap.dedent(FN_GOOD).replace(*edit)
    found, _ = lint(tmp_path, {"ops.py": src}, rules=["autograd-complete"])
    assert rules_of(found) == ["autograd-complete"]
    assert want in found[0].msg


def test_autograd_complete_setup_context_form(tmp_path):
    # forward without ctx: its inputs are all its arguments
    src = """
        from torch.autograd import Function

        class Sq(Function):
            @staticmethod
            def forward(x):
                return x * x

            @staticmethod
            def setup_context(ctx, inputs, output):
                ctx.save_for_backward(inputs[0])

            @staticmethod
            def backward(ctx, g):
                x, = ctx.saved_tensors
                return (2 * x * g,)
    """
    found, _ = lint(tmp_path, {"ops.py": src}, rules=["autograd-complete"])
    assert found == []


# --------------------------------------------- rule 5: recapture

CAPTURE_BAD = """
    import torch

    def run(steps, fn, x):
        for _ in range(steps):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                fn(x)
            g.replay()
"""

CAPTURE_GOOD = """
    import torch

    def run(steps, fn, x):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn(x)
        step = torch.compile(fn)
        for _ in range(steps):
            g.replay()
            step(x)
"""


def test_recapture_bad(tmp_path):
    found, _ = lint(tmp_path, {"run.py": CAPTURE_BAD},
                    rules=["recapture"])
    assert rules_of(found) == ["recapture"] * 2
    assert "torch.cuda.CUDAGraph()" in found[0].msg
    assert "torch.cuda.graph()" in found[1].msg


def test_recapture_good(tmp_path):
    found, _ = lint(tmp_path, {"run.py": CAPTURE_GOOD},
                    rules=["recapture"])
    assert found == []


def test_recapture_compile_and_script_in_while(tmp_path):
    src = """
        import torch

        def run(fn, x):
            while x.sum() > 0:
                torch.compile(fn)(x)
                torch.jit.script(fn)
    """
    found, _ = lint(tmp_path, {"run.py": src}, rules=["recapture"])
    assert rules_of(found) == ["recapture"] * 2


# ------------------------------------------------- rule 6: nondet

@pytest.mark.parametrize("call", [
    "torch.rand(3)", "torch.randn_like(x)", "torch.randperm(4)",
    "torch.randint(0, 4, (2,))", "x.normal_()", "x.bernoulli_(0.5)",
    "F.dropout(x, 0.1)", "nn.Dropout(0.1)", "torch.manual_seed(0)",
    "torch.cuda.manual_seed_all(0)", "np.random.rand(3)",
    "np.random.seed(0)", "random.random()", "random.shuffle(xs)"])
def test_nondet_global_rng_bad(tmp_path, call):
    src = f"""
        import random

        import numpy as np
        import torch
        import torch.nn.functional as F
        from torch import nn

        def draw(x, xs):
            return {call}
    """
    found, _ = lint(tmp_path, {"draw.py": src}, rules=["nondet"])
    assert rules_of(found) == ["nondet"]
    assert "global RNG" in found[0].msg


def test_nondet_explicit_generators_good(tmp_path):
    src = """
        import random

        import numpy as np
        import torch

        def draw(x, seed):
            gen = torch.Generator().manual_seed(seed)
            a = torch.rand(3, generator=gen)
            x.normal_(generator=gen)
            b = np.random.RandomState(seed).permutation(4)
            c = np.random.default_rng(seed).random(2)
            d = random.Random(seed).random()
            return a, b, c, d
    """
    found, _ = lint(tmp_path, {"draw.py": src}, rules=["nondet"])
    assert found == []


def test_nondet_time_inside_graph_capture(tmp_path):
    src = """
        import time

        import torch

        def capture(g, fn, x):
            t0 = time.perf_counter()
            with torch.cuda.graph(g):
                y = fn(x) * time.time()
            return y, time.perf_counter() - t0
    """
    found, _ = lint(tmp_path, {"cap.py": src}, rules=["nondet"])
    assert rules_of(found) == ["nondet"]
    assert "time.time()" in found[0].msg and "capture" in found[0].msg


def test_nondet_time_between_capture_begin_and_end(tmp_path):
    # the port's own capture form (parallel/epoch.py): the statements
    # between <g>.capture_begin() and <g>.capture_end() in one block are
    # captured; reads before and after, and another graph's end, are not
    src = """
        import time
        from datetime import datetime

        import torch

        def capture(graph, other, side, fn, x):
            t0 = time.perf_counter()
            with torch.cuda.stream(side):
                graph.capture_begin(pool=None)
                y = fn(x) + time.monotonic()
                other.capture_end()
                z = y * datetime.now().second
                graph.capture_end()
                w = time.time()
            try:
                other.capture_begin()
                v = fn(x) + time.time_ns()
            finally:
                other.capture_end()
            return y, z, v, w, time.perf_counter() - t0
    """
    found, _ = lint(tmp_path, {"cap.py": src}, rules=["nondet"])
    assert rules_of(found) == ["nondet"] * 3
    assert [f.line for f in found] == [11, 13, 18]
    assert all("CUDA graph capture" in f.msg for f in found)


# -------------------------------- rules 7, 10: flag and gauge drift

CONFIG = """
    import argparse

    def build_parser():
        p = argparse.ArgumentParser()
        p.add_argument("--covered", type=int)
        p.add_argument("--uncovered", type=int)
        return p
"""


def test_flag_drift_bad_as_jax(tmp_path):
    found, _ = both(tmp_path, {"config.py": CONFIG},
                    {"docs/API.md": "only `covered` is documented\n"},
                    rules=["flag-drift"])
    assert rules_of(found) == ["flag-drift"]
    assert "--uncovered" in found[0].msg


def test_flag_drift_good_as_jax(tmp_path):
    found, _ = both(tmp_path, {"config.py": CONFIG},
                    {"docs/API.md": "`covered` and `uncovered`\n"},
                    rules=["flag-drift"])
    assert found == []


@pytest.mark.parametrize("readme,n", [
    ("# x\n\n## PyTorch/CUDA port\n\n`--device cuda|cpu`\n\n## Next\n", 0),
    ("# x\n\n## PyTorch/CUDA port\n\nnothing\n\n## Next\n\n--device\n", 1)])
def test_flag_drift_port_flag_against_readme_port_section(tmp_path, readme,
                                                          n):
    """``--device`` is checked against the README's port section, not
    docs/API.md (the JAX package's)."""
    cfg = CONFIG.replace('"--uncovered"', '"--device"')
    found, _ = lint(tmp_path, {"config.py": cfg},
                    {"docs/API.md": "`covered`\n", "README.md": readme},
                    rules=["flag-drift"])
    assert len(found) == n
    if n:
        assert "port flag --device" in found[0].msg


GAUGES = """
    def render(gauge, stats):
        gauge("dtx_documented_total", stats["a"])
        gauge("dtx_ghost_total", stats["b"])
        gauge("other_metric", stats["c"])
"""


@pytest.mark.parametrize("doc,n", [
    ("`dtx_documented_total`\n", 1),
    ("`dtx_documented_total` `dtx_ghost_total`\n", 0)])
def test_gauge_drift_as_jax(tmp_path, doc, n):
    found, _ = both(tmp_path, {"obs/serve.py": GAUGES},
                    {"docs/API.md": "# api\n",
                     "docs/observability.md": doc},
                    rules=["gauge-drift"])
    assert rules_of(found) == ["gauge-drift"] * n


# ------------------------------------------- rule 8: scope-registry

BUCKETS = """
    WINDOW_BUCKETS = ("data_wait", "dispatch")
    HOST_BUCKET = "host"
    TRACE_SCOPES = WINDOW_BUCKETS + ("eval",)
    NAMED_SCOPES = ("ln",)
"""


def test_scope_registry_bad_as_jax(tmp_path):
    files = {"obs/buckets.py": BUCKETS, "timer.py": """
        def close(timer, tracer, t):
            timer.charge("data_wiat", t)
            with tracer.annotate("evl"):
                pass
    """}
    found, _ = both(tmp_path, files, rules=["scope-registry"])
    assert rules_of(found) == ["scope-registry"] * 2
    assert "'data_wiat'" in found[0].msg and "'evl'" in found[1].msg


def test_scope_registry_named_scopes_through_tracer_scope(tmp_path):
    files = {"obs/buckets.py": BUCKETS, "model.py": """
        from .obs import tracer as tracer_lib

        def apply(x):
            with tracer_lib.scope("ln"):
                x = x + 1
            with tracer_lib.scope("layernorm"):
                return x
    """}
    found, _ = lint(tmp_path, files, rules=["scope-registry"])
    assert rules_of(found) == ["scope-registry"]
    assert "named scope 'layernorm'" in found[0].msg


# ------------------------------------------------- suppression + meta

def test_noqa_suppresses_with_reason_as_jax(tmp_path):
    files = dict(SCHEMA_BAD)
    files["obs/schema.py"] = files["obs/schema.py"].replace(
        '"ghost_field": (int,)}',
        '"ghost_field": (int,)}  # dtx: noqa[schema-drift] fixture')
    found, suppressed = both(tmp_path, files, rules=["schema-drift"])
    assert found == [] and rules_of(suppressed) == ["schema-drift"]


def test_noqa_without_reason_is_a_finding_as_jax(tmp_path):
    files = dict(SCHEMA_BAD)
    files["obs/schema.py"] = files["obs/schema.py"].replace(
        '"ghost_field": (int,)}',
        '"ghost_field": (int,)}  # dtx: noqa[schema-drift]')
    found, suppressed = both(tmp_path, files, rules=["schema-drift"])
    assert sorted(rules_of(found)) == ["noqa-reason", "schema-drift"]
    assert suppressed == []


def test_noqa_suppresses_a_torch_form_rule(tmp_path):
    src = GROUP_BAD.replace(
        "group=other)",
        "group=other)  # dtx: noqa[axis-consistency] fixture reason")
    found, suppressed = lint(tmp_path, {"mesh.py": MESH, "step.py": src},
                             rules=["axis-consistency"])
    assert rules_of(found) == ["axis-consistency"]
    assert rules_of(suppressed) == ["axis-consistency"]


def test_parse_error_is_a_finding_as_jax(tmp_path):
    found, _ = both(tmp_path, {"broken.py": "def f(:\n"}, rules=[])
    assert rules_of(found) == ["parse-error"]


# ------------------------------------------------------------ baseline

def test_baseline_round_trip_as_jax(tmp_path):
    out = {}
    for tag, lib in (("jax", jfind), ("torch", tfind)):
        finds = [lib.Finding("schema-drift", "a.py", 3, "msg one"),
                 lib.Finding("host-sync", "b.py", 7, "msg two", "a hint")]
        path = str(tmp_path / f"{tag}.json")
        lib.write_baseline(path, finds)
        entries = lib.load_baseline(path)
        moved = [lib.Finding("schema-drift", "a.py", 9, "msg one"),
                 lib.Finding("recapture", "c.py", 1, "fresh")]
        new, baselined, stale = lib.split_by_baseline(moved, entries)
        out[tag] = (open(path).read(), [f.msg for f in new],
                    [f.msg for f in baselined], stale)
    assert out["torch"] == out["jax"]
    assert out["torch"][1:3] == (["fresh"], ["msg one"])


def test_baseline_preserves_reasons(tmp_path):
    finds = [tfind.Finding("recapture", "a.py", 1, "kept")]
    path = str(tmp_path / "baseline.json")
    tfind.write_baseline(path, finds)
    entries = tfind.load_baseline(path)
    entries[0]["reason"] = "justified because fixture"
    with open(path, "w") as f:
        json.dump({"v": 1, "findings": entries}, f)
    tfind.write_baseline(path, finds, tfind.load_baseline(path))
    assert tfind.load_baseline(path)[0]["reason"] == \
        "justified because fixture"


def test_baseline_multiset_semantics_as_jax():
    entries = [{"rule": "recapture", "file": "a.py", "msg": "dup"}]
    got = {}
    for tag, lib in (("jax", jfind), ("torch", tfind)):
        finds = [lib.Finding("recapture", "a.py", 1, "dup"),
                 lib.Finding("recapture", "a.py", 2, "dup")]
        new, baselined, stale = lib.split_by_baseline(finds, entries)
        got[tag] = ([f.line for f in new], [f.line for f in baselined],
                    stale)
    assert got["torch"] == got["jax"] == ([2], [1], [])


@pytest.mark.parametrize("text", ['{"v": 99, "findings": []}',
                                  '{"v": 1, "findings": [{"rule": 1}]}'])
def test_corrupt_baseline_rejected_as_jax(tmp_path, text):
    path = tmp_path / "baseline.json"
    path.write_text(text)
    msgs = []
    for lib in (jfind, tfind):
        with pytest.raises(ValueError) as e:
            lib.load_baseline(str(path))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ----------------------------------------------------------- CLI layer

def _codes(argv_fn, capsys):
    codes = []
    for cli in (jcli, tcli):
        codes.append(cli.main(argv_fn()))
        capsys.readouterr()
    assert codes[0] == codes[1]
    return codes[1]


def test_cli_exit_codes_as_jax(tmp_path, capsys):
    clean = make_tree(tmp_path, SCHEMA_GOOD)
    assert _codes(lambda: [clean, "--no-baseline"], capsys) == 0
    (tmp_path / "pkg" / "obs" / "schema.py").write_text(
        textwrap.dedent(SCHEMA_BAD["obs/schema.py"]))
    assert _codes(lambda: [clean, "--no-baseline"], capsys) == 1
    assert _codes(lambda: [str(tmp_path / "nope")], capsys) == 2
    assert _codes(lambda: [clean, "--rules", "not-a-rule"], capsys) == 2
    corrupt = tmp_path / "corrupt.json"
    corrupt.write_text("{not json")
    assert _codes(lambda: [clean, "--baseline", str(corrupt)], capsys) == 2


def test_cli_write_baseline_then_clean(tmp_path, capsys):
    root = make_tree(tmp_path, {"mesh.py": MESH, "bad.py": GROUP_BAD})
    assert tcli.main([root, "--write-baseline"]) == 0
    entries = tfind.load_baseline(
        os.path.join(root, "analysis", "baseline.json"))
    assert len(entries) == 2
    assert tcli.main([root]) == 0
    (tmp_path / "pkg" / "worse.py").write_text(textwrap.dedent(
        GROUP_BAD.replace("dtaa_group", "dtbb_group")))
    capsys.readouterr()
    assert tcli.main([root]) == 1
    out = capsys.readouterr().out
    assert "dtbb_group" in out and "2 new finding(s), 2 baselined" in out


def test_cli_write_baseline_bare_filename(tmp_path, capsys, monkeypatch):
    make_tree(tmp_path, {"mesh.py": MESH, "bad.py": GROUP_BAD})
    monkeypatch.chdir(tmp_path)
    assert tcli.main(["pkg", "--baseline", "bare.json",
                      "--write-baseline"]) == 0
    assert os.path.isfile(tmp_path / "bare.json")
    capsys.readouterr()


def test_cli_write_baseline_rejects_rule_subset(tmp_path, capsys):
    root = make_tree(tmp_path, {"mesh.py": MESH, "bad.py": GROUP_BAD})
    assert tcli.main([root, "--rules", "recapture",
                      "--write-baseline"]) == 2
    assert not os.path.isfile(tmp_path / "pkg" / "analysis"
                              / "baseline.json")
    capsys.readouterr()


def test_lint_repo_root_still_runs_doc_rules_as_jax(tmp_path, capsys):
    (tmp_path / "docs").mkdir()
    (tmp_path / "docs" / "API.md").write_text("nothing documented\n")
    (tmp_path / "config.py").write_text(textwrap.dedent(CONFIG))
    for cli in (jcli, tcli):
        rc = cli.main([str(tmp_path), "--no-baseline", "--rules",
                       "flag-drift"])
        out = capsys.readouterr().out
        assert rc == 1 and "--covered" in out and "--uncovered" in out


def test_cli_json_document_as_jax(tmp_path, capsys):
    root = make_tree(tmp_path, SCHEMA_BAD)
    docs = []
    for cli in (jcli, tcli):
        rc = cli.main([root, "--no-baseline", "--json"])
        docs.append(json.loads(capsys.readouterr().out))
        assert rc == 1
    jdoc, tdoc = docs
    assert tdoc.keys() == jdoc.keys()
    for key in ("v", "root", "modules", "new", "baselined", "suppressed",
                "stale_baseline", "ok"):
        assert tdoc[key] == jdoc[key], key
    assert tdoc["ok"] is False and tdoc["v"] == tcli.JSON_VERSION
    assert tdoc["rules"] == [r.id for r in tcli.ALL_RULES]
    (tmp_path / "pkg" / "obs" / "schema.py").write_text(
        textwrap.dedent(SCHEMA_GOOD["obs/schema.py"]))
    (tmp_path / "pkg" / "obs" / "metrics.py").write_text(
        textwrap.dedent(SCHEMA_GOOD["obs/metrics.py"]))
    rc = tcli.main([root, "--no-baseline", "--json"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0 and doc["ok"] is True and doc["new"] == []


def test_cli_list_rules_names_the_torch_forms(capsys):
    assert tcli.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    ids = [line.split()[0] for line in out.splitlines()]
    assert ids == ["axis-consistency", "host-sync", "schema-drift",
                   "autograd-complete", "recapture", "nondet",
                   "flag-drift", "gauge-drift", "scope-registry",
                   "parse-error", "noqa-reason"]
    assert "torch.autograd.Function" in out and "torch.compile" in out


# ------------------------------------------------------- index details

def test_index_resolves_cross_module_constants(tmp_path):
    import ast as ast_mod

    root = make_tree(tmp_path, {
        "obs/buckets.py": 'HOST_BUCKET = "host"\n',
        "use.py": "from .obs.buckets import HOST_BUCKET\n",
        "abs_use.py": "from pkg.obs.buckets import HOST_BUCKET\n",
    })
    idx = ModuleIndex.build(root)
    for name in ("use.py", "abs_use.py"):
        node = idx.resolve_constant(idx.modules[name], "HOST_BUCKET")
        assert isinstance(node, ast_mod.Constant) and node.value == "host"


def test_index_skips_pycache_and_counts_modules(tmp_path):
    root = make_tree(tmp_path, {"a.py": "x = 1\n"})
    cache = tmp_path / "pkg" / "__pycache__"
    cache.mkdir()
    (cache / "a.cpython-312.py").write_text("broken(\n")
    assert list(ModuleIndex.build(root).modules) == ["a.py"]


# ------------------------------------------ one violation of each rule

PLANTED = {
    "parallel/mesh.py": MESH,
    "parallel/step.py": GROUP_BAD,
    "train/loop.py": LOOP_BAD,
    "obs/schema.py": SCHEMA_BAD["obs/schema.py"],
    "obs/metrics.py": SCHEMA_BAD["obs/metrics.py"],
    "ops/fused.py": FN_GOOD.replace("x, y = ctx.saved_tensors",
                                    "x, y = g, g"),
    "parallel/epoch.py": CAPTURE_BAD,
    "models/mlp.py": "import torch\n\n\ndef init():\n"
                     "    return torch.randn(3)\n",
    "config.py": CONFIG,
    "obs/serve.py": GAUGES,
    "obs/buckets.py": BUCKETS,
    "obs/tracer.py": "def close(timer, t):\n"
                     "    timer.charge('data_wiat', t)\n",
}


def test_planted_tree_names_every_rule(tmp_path, capsys):
    """One torch-form violation of each rule: the CLI exits 1 and its
    --json names all nine, so a rule that stops firing fails here."""
    root = make_tree(tmp_path, PLANTED,
                     {"docs/API.md": "`covered`\n",
                      "docs/observability.md": "`dtx_documented_total`\n"})
    rc = tcli.main([root, "--json"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 1 and doc["ok"] is False
    assert {f["rule"] for f in doc["new"]} == {r.id for r in tcli.ALL_RULES}


# ------------------------------------------------- the whole port

def test_whole_port_lints_clean(capsys):
    """The check of every PR: the port's lint over the port, against
    its baseline, exits 0; its JSON says ok."""
    rc = tcli.main([PKG, "--json"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0 and doc["ok"] is True, doc["new"]
    assert doc["modules"] > 80


def test_whole_port_rules_all_active_and_reasons_recorded():
    """Every rule ran over the port (the Mesh groups, the step loop,
    the schema, buckets and config modules, both docs were found), and
    every baseline entry and every noqa in the port carries a reason."""
    index, ctx, kept, suppressed = tcli.run_lint(PKG)
    assert kept == []
    reg = rules_spmd.group_registry(index)
    assert {"data_group", "model_group", "stage_group", "token_group",
            "batch_group", "group"} <= reg
    loop = index.module_by_suffix("train/loop.py")
    assert loop is not None and "timed_batches" in "\n".join(loop.lines)
    for suffix in ("obs/schema.py", "obs/buckets.py", "obs/serve.py",
                   "obs/compare.py", "config.py"):
        assert index.module_by_suffix(suffix) is not None, suffix
    assert os.path.isfile(ctx.api_md) and os.path.isfile(ctx.readme)
    assert "bench.py" not in index.aux
    # nondet sees the port's one CUDA graph capture, which is
    # capture_begin/capture_end in parallel/epoch.py, and the captured
    # step call inside it
    epoch_mod = index.module_by_suffix("parallel/epoch.py")
    regions = list(rules_spmd.NondeterminismRule()._capture_regions(
        epoch_mod.tree))
    assert len(regions) == 1 and "self._step(" in "\n".join(
        ast.unparse(s) for s in regions[0])
    assert {f.rule for f in suppressed} >= {"axis-consistency", "host-sync",
                                            "recapture"}
    for mod in index.modules.values():
        if mod.relpath.startswith("analysis/"):
            continue    # the rules' own docstrings show the syntax
        for nq in mod.noqa.values():
            assert len(nq.reason) > 20, (mod.relpath, nq.line)
    entries = tfind.load_baseline(os.path.join(PKG, "analysis",
                                               "baseline.json"))
    for entry in entries:
        assert entry.get("reason") and not re.match(
            r"grandfathered", entry["reason"]), entry


def test_module_runs_as_a_script():
    """``python -m ...analysis.cli --list-rules`` exits 0 (no console
    script: pyproject.toml changes only to name the package)."""
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, "-m",
         "distributed_tensorflow_example_tpu_torch.analysis.cli",
         "--list-rules"], cwd=REPO, capture_output=True, text=True,
        timeout=60)
    assert out.returncode == 0 and "autograd-complete" in out.stdout
