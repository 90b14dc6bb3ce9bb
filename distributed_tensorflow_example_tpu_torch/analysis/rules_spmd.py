"""SPMD-layer rules in torch form: process-group names at collective
call sites, ``torch.autograd.Function`` completeness, recapture and
nondeterminism hazards (the JAX package's ``analysis/rules_spmd.py``,
whose ``lax.*`` and ``jax.*`` forms cannot see this package).

A ``torch.distributed`` collective names the ranks it runs over by its
``group=``: the wrong group sums over the wrong ranks, and a collective
without one runs over the world, which hangs as soon as only one axis's
ranks post it.  Both run fine on one rank and fail only on the full
layout, the same failure class as a typo'd mesh axis name in JAX.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, List, Optional, Set

from .findings import Finding
from .index import Module, ModuleIndex, function_assigns

# torch.distributed collective -> positional index of its group argument
COLLECTIVES: Dict[str, int] = {
    "all_reduce": 2, "all_gather": 2, "all_gather_into_tensor": 2,
    "all_gather_object": 2, "all_gather_single": 2,
    "reduce_scatter": 3, "reduce_scatter_tensor": 3,
    "reduce_scatter_single": 3, "all_to_all_single": 4, "all_to_all": 2,
    "broadcast": 2, "broadcast_object_list": 2, "barrier": 0,
    "P2POp": 3,
}

# the package's own wrappers of collectives (cluster.py), the same way
WRAPPERS: Dict[str, int] = {"all_gather_flat": 2, "reduce_scatter_flat": 2}

_GROUPISH_RE = re.compile(r"group", re.IGNORECASE)


def dotted(node: ast.expr) -> str:
    """``a.b.c`` for an attribute chain rooted at a name, else ""."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return ""
    parts.append(node.id)
    return ".".join(reversed(parts))


def _groupish(name: str) -> bool:
    """The dynamic-argument naming convention: an unresolvable group
    expression is accepted iff its name says it is one."""
    return bool(_GROUPISH_RE.search(name))


def _is_dataclass(cls: ast.ClassDef) -> bool:
    for dec in cls.decorator_list:
        base = dec.func if isinstance(dec, ast.Call) else dec
        if dotted(base).split(".")[-1] == "dataclass":
            return True
    return False


def _is_property(fn: ast.FunctionDef) -> bool:
    return any(dotted(d) == "property" for d in fn.decorator_list)


def group_registry(index: ModuleIndex) -> Set[str]:
    """The attribute names that hold a process group: the ``Mesh``
    dataclass's ``*_group`` fields and its properties named so
    (``token_group``, ``batch_group``), plus ``group`` when a class of
    the tree (an axis record) declares such a field.  Empty when the
    tree has no ``Mesh`` dataclass: the rule is then inactive."""
    reg: Set[str] = set()
    records = False
    for mod in index.modules.values():
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            for item in node.body:
                name = None
                if isinstance(item, ast.AnnAssign) and isinstance(
                        item.target, ast.Name):
                    name = item.target.id
                elif isinstance(item, ast.FunctionDef) and _is_property(
                        item):
                    name = item.name
                if name is None:
                    continue
                if (node.name == "Mesh" and _is_dataclass(node)
                        and name.endswith("_group")):
                    reg.add(name)
                elif name == "group" and isinstance(item, ast.AnnAssign):
                    records = True
    if reg and records:
        reg.add("group")
    return reg


def _dist_aliases(mod: Module) -> Set[str]:
    """Names ``torch.distributed`` is bound to anywhere in the module
    (``import torch.distributed as dist`` inside a function too)."""
    out: Set[str] = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            out |= {a.asname for a in node.names
                    if a.name == "torch.distributed" and a.asname}
        elif isinstance(node, ast.ImportFrom) and node.module == "torch":
            out |= {a.asname or a.name for a in node.names
                    if a.name == "distributed"}
    return out


def collective_name(mod: Module, func: ast.expr,
                    aliases: Set[str]) -> Optional[str]:
    """``dist.all_reduce`` for a torch.distributed collective (through
    any alias of the module, or ``torch.distributed.x``), the wrapper's
    name for ``cluster.all_gather_flat``-shaped calls, else None."""
    name = dotted(func)
    if not name:
        return None
    parts = name.split(".")
    last = parts[-1]
    if len(parts) == 1:
        src = mod.from_imports.get(last)
        if src is not None and src[0] == "torch.distributed" \
                and src[1] in COLLECTIVES:
            return f"dist.{src[1]}"
        if src is not None and src[1] in WRAPPERS:
            return f"cluster.{src[1]}"
        return None
    root = ".".join(parts[:-1])
    if last in COLLECTIVES and (root == "torch.distributed"
                                or root in aliases):
        return f"dist.{last}"
    if last in WRAPPERS and parts[-2] == "cluster":
        return f"cluster.{last}"
    return None


class GroupConsistencyRule:
    """rule 1 (torch form): every collective names its process group,
    and that group is a mesh group, a name that says it is one, or a
    local assigned from either; a collective without ``group=`` runs
    over the world and is a finding unless its noqa says why."""

    id = "axis-consistency"
    doc = ("torch.distributed collectives (and cluster's wrappers) need "
           "group= of a Mesh group (or a conventioned *group* name); "
           "no group= runs over the world")

    def check(self, index: ModuleIndex, ctx) -> List[Finding]:
        registry = group_registry(index)
        if not registry:
            return []  # no Mesh in this tree: rule inactive
        out: List[Finding] = []
        for mod in index.modules.values():
            out.extend(self._check_module(mod, registry))
        return out

    def _check_module(self, mod: Module,
                      registry: Set[str]) -> List[Finding]:
        findings: List[Finding] = []
        func_stack: List[Dict[str, ast.expr]] = []
        aliases = _dist_aliases(mod)

        def local_lookup() -> Dict[str, ast.expr]:
            merged: Dict[str, ast.expr] = {}
            for scope in func_stack:
                merged.update(scope)
            return merged

        def bad_parts(node: ast.expr, depth: int = 0) -> List[str]:
            """The parts of a group expression that are neither mesh
            groups nor conventioned names."""
            if depth > 6:
                return ["<too deep>"]
            if isinstance(node, ast.Attribute):
                # an attribute is a registry name or a finding: the
                # naming convention covers only dynamic names (a typo'd
                # mesh.dat_group must not pass for saying "group")
                if node.attr in registry:
                    return []
                return [dotted(node) or ast.unparse(node)]
            if isinstance(node, ast.IfExp):
                return (bad_parts(node.body, depth + 1)
                        + bad_parts(node.orelse, depth + 1))
            if isinstance(node, ast.Name):
                if _groupish(node.id):
                    return []
                val = local_lookup().get(node.id)
                if val is not None:
                    return bad_parts(val, depth + 1)
                return [node.id]
            if isinstance(node, ast.Subscript):
                return bad_parts(node.value, depth + 1)
            if isinstance(node, ast.Call):
                name = dotted(node.func)
                if name and _groupish(name.split(".")[-1]):
                    return []
            if isinstance(node, ast.Constant) and node.value is None:
                return ["None (the world)"]
            return [ast.unparse(node)]

        def check_call(call: ast.Call, name: str, pos: int) -> None:
            group = None
            for kw in call.keywords:
                if kw.arg == "group":
                    group = kw.value
            if group is None and len(call.args) > pos:
                group = call.args[pos]
            if group is None:
                findings.append(Finding(
                    rule=self.id, file=mod.relpath, line=call.lineno,
                    msg=(f"{name} with no group= runs over the world"),
                    hint=("pass the mesh group it means (parallel/mesh.py "
                          "Mesh.*_group); a world collective sums over "
                          "every axis and hangs when only one axis's "
                          "ranks post it, or say why the world is right: "
                          "# dtx: noqa[axis-consistency] <reason>")))
                return
            for desc in bad_parts(group):
                findings.append(Finding(
                    rule=self.id, file=mod.relpath, line=call.lineno,
                    msg=(f"{name} over group {desc!r}, which is neither "
                         f"a mesh group ({sorted(registry)}) nor named "
                         f"like one"),
                    hint=("pass a Mesh *_group (or an axis record's "
                          ".group), or a variable named *group* that "
                          "holds one")))

        def visit(node: ast.AST) -> None:
            pushed = False
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                func_stack.append(function_assigns(node))
                pushed = True
            if isinstance(node, ast.Call):
                name = collective_name(mod, node.func, aliases)
                if name is not None:
                    short = name.split(".")[-1]
                    pos = COLLECTIVES.get(short, WRAPPERS.get(short))
                    check_call(node, name, pos)
            for child in ast.iter_child_nodes(node):
                visit(child)
            if pushed:
                func_stack.pop()

        visit(mod.tree)
        return findings


def _is_autograd_function(cls: ast.ClassDef) -> bool:
    for base in cls.bases:
        name = dotted(base)
        if name in ("torch.autograd.Function", "autograd.Function",
                    "Function"):
            return True
    return False


def _is_staticmethod(fn: ast.FunctionDef) -> bool:
    return any(dotted(d) == "staticmethod" for d in fn.decorator_list)


def _positional(fn: ast.FunctionDef) -> List[str]:
    return [a.arg for a in list(fn.args.posonlyargs) + list(fn.args.args)]


def _own_nodes(fn: ast.FunctionDef):
    """The nodes of ``fn``'s body, not descending into nested defs."""
    stack: List[ast.AST] = list(fn.body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _calls_attr(fn: ast.FunctionDef, obj: str, attr: str) -> bool:
    return any(isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
               and n.func.attr == attr and isinstance(n.func.value, ast.Name)
               and n.func.value.id == obj for n in _own_nodes(fn))


def _reads_attr(fn: ast.FunctionDef, obj: str, attr: str) -> bool:
    return any(isinstance(n, ast.Attribute) and n.attr == attr
               and isinstance(n.value, ast.Name) and n.value.id == obj
               for n in _own_nodes(fn))


class AutogradCompleteRule:
    """rule 4 (torch form of ``vjp-complete``): every
    ``torch.autograd.Function`` has ``forward`` and ``backward`` as
    static methods, ``backward`` returns one gradient per input of
    ``forward``, and reads the tensors ``forward`` saved for it."""

    id = "autograd-complete"
    doc = ("torch.autograd.Function subclasses need static forward and "
           "backward, one gradient per forward input, and saved tensors "
           "read")

    def check(self, index: ModuleIndex, ctx) -> List[Finding]:
        out: List[Finding] = []
        for mod in index.modules.values():
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.ClassDef) \
                        and _is_autograd_function(node):
                    out.extend(self._check_class(mod, node))
        return out

    def _check_class(self, mod: Module,
                     cls: ast.ClassDef) -> List[Finding]:
        findings: List[Finding] = []

        def add(line: int, msg: str, hint: str) -> None:
            findings.append(Finding(rule=self.id, file=mod.relpath,
                                    line=line, msg=msg, hint=hint))

        methods = {item.name: item for item in cls.body
                   if isinstance(item, ast.FunctionDef)}
        for role in ("forward", "backward"):
            fn = methods.get(role)
            if fn is None:
                add(cls.lineno,
                    f"autograd.Function {cls.name!r} has no {role}",
                    ("without it the first backward through the "
                     "Function raises, a failure a forward-only test "
                     "never reaches" if role == "backward" else
                     "define forward(ctx, ...)"))
            elif not _is_staticmethod(fn):
                add(fn.lineno,
                    f"{cls.name}.{role} is not a @staticmethod",
                    "autograd calls forward/backward on the class: "
                    "decorate both with @staticmethod")
        fwd, bwd = methods.get("forward"), methods.get("backward")
        if fwd is None or bwd is None:
            return findings
        setup = methods.get("setup_context")
        fwd_args = _positional(fwd)
        n_inputs = len(fwd_args) - (0 if setup is not None else 1)
        if fwd.args.vararg is None:
            for node in _own_nodes(bwd):
                if not (isinstance(node, ast.Return)
                        and isinstance(node.value, ast.Tuple)):
                    continue
                if any(isinstance(e, ast.Starred) for e in node.value.elts):
                    continue
                got = len(node.value.elts)
                if got != n_inputs:
                    add(node.lineno,
                        (f"{cls.name}.backward returns {got} gradients; "
                         f"forward takes {n_inputs} inputs after ctx"),
                        ("return one gradient (or None) per forward "
                         "input, in order"))
        saver = setup if setup is not None else fwd
        saver_args = _positional(saver)
        bwd_args = _positional(bwd)
        if saver_args and bwd_args and _calls_attr(
                saver, saver_args[0], "save_for_backward") \
                and not _reads_attr(bwd, bwd_args[0], "saved_tensors"):
            add(bwd.lineno,
                (f"{cls.name}.backward never reads "
                 f"{bwd_args[0]}.saved_tensors that forward saved"),
                ("either forward saves tensors nobody uses (memory held "
                 "to the backward) or backward recomputes what it has"))
        return findings


# calls that build (and capture or compile) a new program
_CAPTURES = ("torch.cuda.CUDAGraph", "cuda.CUDAGraph", "CUDAGraph",
             "torch.cuda.graph", "cuda.graph", "torch.compile",
             "torch.jit.script", "jit.script", "torch.jit.trace",
             "jit.trace")


class RecaptureRule:
    """rule 5 (torch form of ``retrace``): a CUDA graph, ``torch.compile``
    or TorchScript built inside a loop body captures (or compiles) anew
    every iteration."""

    id = "recapture"
    doc = ("torch.cuda.CUDAGraph/graph, torch.compile and torch.jit "
           "script/trace called inside a for/while body rebuild their "
           "program every iteration")

    def check(self, index: ModuleIndex, ctx) -> List[Finding]:
        out: List[Finding] = []
        for mod in index.modules.values():
            loop_depth = 0

            def visit(node: ast.AST) -> None:
                nonlocal loop_depth
                if isinstance(node, ast.Call) and loop_depth \
                        and dotted(node.func) in _CAPTURES:
                    out.append(Finding(
                        rule=self.id, file=mod.relpath, line=node.lineno,
                        msg=(f"{dotted(node.func)}() called inside a loop "
                             f"body: every iteration captures (or "
                             f"compiles) a new program"),
                        hint=("build it once before the loop and replay "
                              "the same graph or compiled callable each "
                              "iteration")))
                if isinstance(node, (ast.For, ast.While)):
                    # the iterable/condition itself is outside the body
                    loop_depth += 1
                    for child in node.body + node.orelse:
                        visit(child)
                    loop_depth -= 1
                    return
                for child in ast.iter_child_nodes(node):
                    visit(child)

            visit(mod.tree)
        return out


# torch's draws from the global generator unless given generator=
_TORCH_DRAWS = {
    "rand", "randn", "randint", "randperm", "bernoulli", "multinomial",
    "normal", "poisson", "rand_like", "randn_like", "randint_like",
}
_INPLACE_DRAWS = {"uniform_", "normal_", "bernoulli_", "random_",
                  "exponential_", "cauchy_", "log_normal_", "geometric_"}
_DROPOUT_FNS = {"dropout", "dropout1d", "dropout2d", "dropout3d",
                "alpha_dropout", "feature_alpha_dropout"}
_DROPOUT_MODULES = {"Dropout", "Dropout1d", "Dropout2d", "Dropout3d",
                    "AlphaDropout", "FeatureAlphaDropout"}
_GLOBAL_SEEDS = {"torch.manual_seed", "torch.seed", "torch.random.manual_seed",
                 "torch.random.seed", "torch.cuda.manual_seed",
                 "torch.cuda.manual_seed_all", "torch.cuda.seed",
                 "torch.cuda.seed_all"}
# explicit generators (and their seeding helpers): allowed
_NP_GENERATORS = {"RandomState", "default_rng", "Generator", "SeedSequence",
                  "PCG64", "PCG64DXSM", "Philox", "MT19937", "SFC64",
                  "BitGenerator"}
_PY_GENERATORS = {"Random", "SystemRandom"}

_NONDET_TIME = {"time", "perf_counter", "monotonic", "time_ns",
                "perf_counter_ns", "monotonic_ns"}


def _has_generator(call: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in call.keywords)


class NondeterminismRule:
    """rule 6 (torch form): the port's contract is explicit random
    generators, and the port is eager, so the whole package is scanned
    for draws from a global RNG (torch's, numpy's, Python's) and for
    seeding it; inside a CUDA graph capture (a ``with
    torch.cuda.graph(...)`` body, or the statements between
    ``<g>.capture_begin(...)`` and ``<g>.capture_end()`` in one block), a
    wall-clock read is baked into the captured graph."""

    id = "nondet"
    doc = ("global-RNG draws (torch.rand*/dropout/manual_seed without a "
           "Generator, np.random.*, random.*) anywhere, and time reads "
           "inside a CUDA graph capture")

    def check(self, index: ModuleIndex, ctx) -> List[Finding]:
        out: List[Finding] = []
        for mod in index.modules.values():
            out.extend(self._check_module(mod))
        return out

    @staticmethod
    def _global_draw(mod: Module, call: ast.Call) -> Optional[str]:
        name = dotted(call.func)
        parts = name.split(".") if name else []
        last = parts[-1] if parts else (
            call.func.attr if isinstance(call.func, ast.Attribute) else "")
        if name in _GLOBAL_SEEDS:
            return f"{name}()"
        if _has_generator(call):
            return None
        if len(parts) == 2 and parts[0] == "torch" and last in _TORCH_DRAWS:
            return f"{name}()"
        if last in _INPLACE_DRAWS and isinstance(call.func, ast.Attribute):
            return f".{last}()"
        if last in _DROPOUT_FNS and len(parts) >= 2 and (
                parts[-2] in ("F", "functional") or parts[0] == "torch"):
            return f"{name}()"
        if last in _DROPOUT_MODULES:
            return f"{name}()"
        if len(parts) == 3 and parts[0] in ("np", "numpy") \
                and parts[1] == "random" and last not in _NP_GENERATORS:
            return f"np.random.{last}()"
        if len(parts) == 2 and parts[0] == "random" \
                and mod.imports.get("random") == "random" \
                and last not in _PY_GENERATORS:
            return f"random.{last}()"
        return None

    @staticmethod
    def _time_read(call: ast.Call) -> Optional[str]:
        f = call.func
        if not isinstance(f, ast.Attribute):
            return None
        root = f.value.id if isinstance(f.value, ast.Name) else None
        if root == "time" and f.attr in _NONDET_TIME:
            return f"time.{f.attr}()"
        if root in ("datetime", "dt") and f.attr in ("now", "utcnow",
                                                     "today"):
            return f"datetime.{f.attr}()"
        if root == "os" and f.attr == "urandom":
            return "os.urandom()"
        return None

    @staticmethod
    def _method_call(stmt: ast.stmt, method: str) -> Optional[str]:
        """The receiver of ``stmt`` when it is ``<receiver>.<method>(...)``
        ("<expr>" for a receiver with no dotted name)."""
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            f = stmt.value.func
            if isinstance(f, ast.Attribute) and f.attr == method:
                return dotted(f.value) or "<expr>"
        return None

    def _capture_regions(self, tree: ast.AST) -> Iterator[List[ast.stmt]]:
        """The statement lists a CUDA graph captures: each ``with
        torch.cuda.graph(...)`` body, and in every block the statements
        from ``<g>.capture_begin(...)`` to ``<g>.capture_end()`` (to the
        block's end when the end is elsewhere, e.g. a ``finally``)."""
        for node in ast.walk(tree):
            if isinstance(node, ast.With) and any(
                    isinstance(it.context_expr, ast.Call)
                    and dotted(it.context_expr.func) in (
                        "torch.cuda.graph", "cuda.graph")
                    for it in node.items):
                yield node.body
            for field in ("body", "orelse", "finalbody"):
                stmts = getattr(node, field, None)
                if not isinstance(stmts, list):
                    continue
                start, graph = None, None
                for i, stmt in enumerate(stmts):
                    if start is None:
                        graph = self._method_call(stmt, "capture_begin")
                        if graph is not None:
                            start = i + 1
                    elif self._method_call(stmt, "capture_end") == graph:
                        yield stmts[start:i]
                        start = None
                if start is not None:
                    yield stmts[start:]

    def _check_module(self, mod: Module) -> List[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call):
                bad = self._global_draw(mod, node)
                if bad is not None:
                    findings.append(Finding(
                        rule=self.id, file=mod.relpath, line=node.lineno,
                        msg=(f"{bad} draws from (or seeds) a global RNG: "
                             f"its stream depends on every earlier draw "
                             f"in the process"),
                        hint=("draw from an explicit torch.Generator "
                              "(generator=), np.random.RandomState/"
                              "default_rng(seed) or random.Random(seed) "
                              "seeded from the run's --seed")))
        seen: Set[int] = set()
        for region in self._capture_regions(mod.tree):
            for inner in region:
                for sub in ast.walk(inner):
                    if not isinstance(sub, ast.Call) or id(sub) in seen:
                        continue
                    seen.add(id(sub))
                    bad = self._time_read(sub)
                    if bad is not None:
                        findings.append(Finding(
                            rule=self.id, file=mod.relpath,
                            line=sub.lineno,
                            msg=(f"{bad} inside a CUDA graph capture: "
                                 f"the value read at capture is baked "
                                 f"into every replay"),
                            hint=("read it outside the capture and "
                                  "copy it into a static input "
                                  "tensor before each replay")))
        return findings
