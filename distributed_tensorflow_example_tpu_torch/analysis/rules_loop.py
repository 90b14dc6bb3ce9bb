"""rule 2 — host-sync-in-hot-loop, over the port's step window.

The host path keeps up to ``--dispatch_depth`` steps in flight on the
card (a window of CUDA events) and fetches costs, flags and norms once
per window; ONE stray blocking read inside the step window serializes
host and card again and that overlap is gone, with nothing failing.
This rule guards the loop structurally: the hot region is the ``for
... in timed_batches(...)`` step window in ``train/loop.py`` plus every
module-local function it calls (transitively), and inside it every
host-sync construct must sit inside a sanctioned fetch site — a ``with
tracer.annotate(...)`` block (the drain and window-boundary sites,
which charge their wall into the metrics buckets; a local function
called there, such as the loop's ``_fetch``, runs inside the site) —
or carry an explicit ``# dtx: noqa[host-sync] reason``:

- ``.item()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``;
- ``torch.cuda.synchronize()`` and ``<event|stream>.synchronize()``;
- ``.tolist()``, ``float()``, ``int()``, ``bool()``, ``print()`` and
  ``np.asarray()`` of a device value.

Device values are recognized by the port loop's own naming convention
(``train/loop.py``'s host path): ``*_dev`` names (``cost_dev``,
``norms_dev``, the anomaly entry's ``c_dev``/``a_dev``), ``extra`` (the
step's outputs past cost and accuracy), the ``pending`` and
``anom_pending`` queues of steps not yet fetched, and ``inflight``, the
events of the steps on the card — and expressions rooted at them.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from .findings import Finding
from .rules_spmd import dotted

# sync whatever they are called on (torch tensors, events, streams)
_SYNC_ATTRS = {"item", "cpu", "numpy", "synchronize"}
_DEVICEISH_SUFFIXES = ("_dev", "_pending")
_DEVICEISH_NAMES = {"inflight", "pending", "extra"}


def _root_name(node: ast.expr) -> Optional[str]:
    while isinstance(node, (ast.Subscript, ast.Attribute, ast.Call)):
        node = (node.value if not isinstance(node, ast.Call)
                else node.func)
    return node.id if isinstance(node, ast.Name) else None


def _deviceish(node: ast.expr) -> bool:
    name = _root_name(node)
    return bool(name) and (name in _DEVICEISH_NAMES
                           or name.endswith(_DEVICEISH_SUFFIXES))


def _is_annotate_with(node: ast.With) -> bool:
    for item in node.items:
        expr = item.context_expr
        if isinstance(expr, ast.Call) and isinstance(
                expr.func, ast.Attribute) and expr.func.attr in (
                    "annotate", "step_annotation"):
            return True
    return False


def _to_cpu(node: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")`` /
    ``x.to(torch.device("cpu"))``."""
    for a in node.args[:1] + [kw.value for kw in node.keywords
                              if kw.arg == "device"]:
        if isinstance(a, ast.Constant) and a.value == "cpu":
            return True
        if isinstance(a, ast.Call) and dotted(a.func) == "torch.device" \
                and a.args and isinstance(a.args[0], ast.Constant) \
                and a.args[0].value == "cpu":
            return True
    return False


class HostSyncRule:
    id = "host-sync"
    doc = ("blocking card reads inside train/loop.py's step window must "
           "ride the sanctioned (tracer-annotated) fetch sites")

    def check(self, index, ctx) -> List[Finding]:
        mod = index.module_by_suffix("train/loop.py")
        if mod is None:
            return []
        findings: List[Finding] = []

        # module-local function definitions, by name (outermost wins)
        local_defs: Dict[str, ast.FunctionDef] = {}
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.FunctionDef):
                local_defs.setdefault(node.name, node)

        hot_loops = [
            node for node in ast.walk(mod.tree)
            if isinstance(node, ast.For)
            and isinstance(node.iter, ast.Call)
            and ((isinstance(node.iter.func, ast.Name)
                  and node.iter.func.id == "timed_batches")
                 or (isinstance(node.iter.func, ast.Attribute)
                     and node.iter.func.attr == "timed_batches"))
        ]
        if not hot_loops:
            return []

        visited_fns: Set[str] = set()
        for loop in hot_loops:
            for node in loop.body:
                self._scan_node(node, False, mod, findings, local_defs,
                                visited_fns)
        return findings

    def _scan_node(self, node: ast.AST, sanctioned: bool, mod,
                   findings: List[Finding],
                   local_defs: Dict[str, ast.FunctionDef],
                   visited_fns: Set[str]) -> None:
        if isinstance(node, ast.With) and _is_annotate_with(node):
            for child in node.body:
                self._scan_node(child, True, mod, findings, local_defs,
                                visited_fns)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return  # defs nested in the loop run only when called
        if isinstance(node, ast.Call):
            self._check_call(node, sanctioned, mod, findings)
            # expand module-local callees into the hot region, once; a
            # callee called inside a sanctioned site runs inside it
            # (the loop's fetch helper), so only unsanctioned calls
            # expand
            callee = None
            if isinstance(node.func, ast.Name) and not sanctioned:
                callee = node.func.id
            if callee and callee in local_defs and callee not in \
                    visited_fns:
                visited_fns.add(callee)
                for child in local_defs[callee].body:
                    self._scan_node(child, False, mod, findings,
                                    local_defs, visited_fns)
        for child in ast.iter_child_nodes(node):
            self._scan_node(child, sanctioned, mod, findings, local_defs,
                            visited_fns)

    def _check_call(self, node: ast.Call, sanctioned: bool, mod,
                    findings: List[Finding]) -> None:
        if sanctioned:
            return
        what = None
        fn = node.func
        if isinstance(fn, ast.Attribute):
            if fn.attr in _SYNC_ATTRS and not node.args:
                what = ("torch.cuda.synchronize()"
                        if dotted(fn) == "torch.cuda.synchronize"
                        else f".{fn.attr}()")
            elif dotted(fn) == "torch.cuda.synchronize":
                what = "torch.cuda.synchronize()"
            elif fn.attr == "to" and _to_cpu(node):
                what = '.to("cpu")'
            elif fn.attr == "tolist" and _deviceish(fn.value):
                what = ".tolist() of a device value"
            elif fn.attr == "asarray" and isinstance(fn.value, ast.Name) \
                    and fn.value.id in ("np", "numpy") and node.args \
                    and _deviceish(node.args[0]):
                what = "np.asarray(<device value>)"
        elif isinstance(fn, ast.Name):
            if fn.id in ("float", "int", "bool") and node.args \
                    and _deviceish(node.args[0]):
                what = f"{fn.id}(<device value>)"
            elif fn.id == "print" and any(_deviceish(a)
                                          for a in node.args):
                what = "print(<device value>)"
        if what is not None:
            findings.append(Finding(
                rule=self.id, file=mod.relpath, line=node.lineno,
                msg=(f"{what} inside the step window blocks the host "
                     f"on the card outside a sanctioned fetch site"),
                hint=("move the fetch into a `with tracer.annotate(...)"
                      "` drain/window site so its wall is charged to a "
                      "bucket, or suppress with "
                      "# dtx: noqa[host-sync] <reason>")))
