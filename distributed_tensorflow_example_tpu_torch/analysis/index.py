"""The shared parsed-module index every lint rule visits: the port's
copy of the JAX package's ``analysis/index.py``.

One parse of the tree, many independent visitors: ``ModuleIndex``
walks a package directory (or a single file), parses every ``*.py``
with ``ast``, and keeps per-module context the rules need —

- the AST and raw source lines;
- ``# dtx: noqa[RULE] reason`` suppression directives per line;
- module-level constants (strings / numbers / tuples), with
  cross-module resolution through relative imports and module
  aliases, so a rule can resolve ``buckets.WINDOW_BUCKETS`` or
  ``from .buckets import HOST_BUCKET`` down to its literals;
- every string literal in the module (the cheap "does this module
  mention key X anywhere" query the contract rules use).

Everything here is stdlib-only; nothing from the linted tree is ever
imported or executed.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

# "# dtx: noqa[rule-a,rule-b] free-form reason" — the reason is
# REQUIRED (the cli emits a noqa-reason finding when it is empty):
# a suppression without a recorded why is exactly the undocumented
# drift this linter exists to stop.
NOQA_RE = re.compile(
    r"#\s*dtx:\s*noqa\[([A-Za-z0-9_,\- ]+)\]\s*(.*?)\s*$")


@dataclass
class Noqa:
    line: int
    rules: frozenset
    reason: str


@dataclass
class Module:
    """One parsed source file plus the per-line/per-name context."""

    relpath: str                 # posix-style, relative to the lint root
    abspath: str
    tree: ast.Module
    lines: List[str]
    noqa: Dict[int, Noqa] = field(default_factory=dict)
    # alias -> dotted module name, for both `import a.b as c` (c ->
    # a.b) and plain `import a.b` (a -> a; attribute chains resolve
    # through it)
    imports: Dict[str, str] = field(default_factory=dict)
    # name -> (dotted source module, original name) for `from m import x`
    from_imports: Dict[str, Tuple[str, str]] = field(default_factory=dict)
    # module-level simple assignments: name -> value AST node
    const_nodes: Dict[str, ast.expr] = field(default_factory=dict)
    str_literals: Set[str] = field(default_factory=set)

    def noqa_for(self, line: int) -> Optional[Noqa]:
        return self.noqa.get(line)


def _collect_module_facts(mod: Module) -> None:
    for i, text in enumerate(mod.lines, 1):
        m = NOQA_RE.search(text)
        if m:
            rules = frozenset(
                r.strip() for r in m.group(1).split(",") if r.strip())
            mod.noqa[i] = Noqa(line=i, rules=rules,
                               reason=m.group(2).strip())
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            mod.str_literals.add(node.value)
    for node in mod.tree.body:
        if isinstance(node, ast.Import):
            for alias in node.names:
                mod.imports[alias.asname or alias.name.split(".")[0]] = \
                    alias.name
        elif isinstance(node, ast.ImportFrom):
            level = node.level or 0
            src = ("." * level) + (node.module or "")
            for alias in node.names:
                if alias.name == "*":
                    continue
                local = alias.asname or alias.name
                # `from . import mesh as mesh_lib` binds a MODULE
                if node.module is None or _looks_like_module(alias.name):
                    mod.imports.setdefault(local, src + "." + alias.name
                                           if node.module else
                                           src + alias.name)
                mod.from_imports[local] = (src, alias.name)
        elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            mod.const_nodes[node.targets[0].id] = node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None \
                and isinstance(node.target, ast.Name):
            mod.const_nodes[node.target.id] = node.value


def _looks_like_module(name: str) -> bool:
    # heuristic only used to ALSO record a from-import as a module
    # alias; constants resolve through from_imports regardless
    return name.islower() and "_" not in name[:1]


class ModuleIndex:
    """Parse a tree once; answer the rules' structural queries."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self.modules: Dict[str, Module] = {}
        self.parse_errors: List[Tuple[str, int, str]] = []
        self.aux: Dict[str, Module] = {}  # out-of-tree helpers

    # -- construction -----------------------------------------------------

    @classmethod
    def build(cls, root: str) -> "ModuleIndex":
        idx = cls(root)
        if os.path.isfile(idx.root):
            idx._add_file(idx.root, os.path.basename(idx.root))
            return idx
        for dirpath, dirnames, filenames in os.walk(idx.root):
            dirnames[:] = sorted(d for d in dirnames
                                 if d != "__pycache__"
                                 and not d.startswith("."))
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    abspath = os.path.join(dirpath, fn)
                    rel = os.path.relpath(abspath, idx.root).replace(
                        os.sep, "/")
                    idx._add_file(abspath, rel)
        return idx

    def _parse(self, abspath: str, relpath: str) -> Optional[Module]:
        try:
            with open(abspath, encoding="utf-8") as f:
                source = f.read()
            tree = ast.parse(source, filename=relpath)
        except (OSError, SyntaxError, ValueError) as e:
            line = getattr(e, "lineno", 0) or 0
            self.parse_errors.append((relpath, line, str(e)))
            return None
        mod = Module(relpath=relpath, abspath=abspath, tree=tree,
                     lines=source.splitlines())
        _collect_module_facts(mod)
        return mod

    def _add_file(self, abspath: str, relpath: str) -> None:
        mod = self._parse(abspath, relpath)
        if mod is not None:
            self.modules[relpath] = mod

    def add_aux_file(self, abspath: str) -> Optional[Module]:
        """Parse an out-of-tree helper (a bench script beside the
        package) as a key source for the contract rules. Aux modules are
        never themselves linted; a broken aux file is simply absent."""
        if not os.path.isfile(abspath):
            return None
        name = os.path.basename(abspath)
        errs_before = len(self.parse_errors)
        mod = self._parse(abspath, name)
        del self.parse_errors[errs_before:]  # aux parse errors don't count
        if mod is not None:
            self.aux[name] = mod
        return mod

    # -- queries ----------------------------------------------------------

    def module_by_suffix(self, suffix: str) -> Optional[Module]:
        """The module whose relpath ends with ``suffix`` (shortest
        relpath wins, so 'config.py' prefers the package root's over
        a nested one)."""
        hits = [m for rel, m in self.modules.items()
                if rel == suffix or rel.endswith("/" + suffix)]
        if not hits and suffix in self.aux:
            return self.aux[suffix]
        return min(hits, key=lambda m: len(m.relpath)) if hits else None

    def _resolve_relative(self, mod: Module, dotted: str) -> Optional[Module]:
        """Map an import source ('.mesh', '..parallel.mesh', or an
        absolute 'pkg.parallel.mesh') to a module in the index."""
        if dotted.startswith("."):
            level = len(dotted) - len(dotted.lstrip("."))
            tail = [p for p in dotted.lstrip(".").split(".") if p]
            base = mod.relpath.split("/")[:-1]
            if level > 1:
                base = base[: len(base) - (level - 1)]
                if len(mod.relpath.split("/")) - 1 < level - 1:
                    return None
            parts = base + tail
        else:
            parts = dotted.split(".")
            # absolute: strip the root package name when it matches
            pkg = os.path.basename(self.root.rstrip(os.sep))
            if parts and parts[0] == pkg.removesuffix(".py"):
                parts = parts[1:]
        for cand in ("/".join(parts) + ".py",
                     "/".join(parts + ["__init__.py"]) if parts else ""):
            if cand in self.modules:
                return self.modules[cand]
        return None

    def resolve_constant(self, mod: Module, name: str,
                         _depth: int = 0) -> Optional[ast.expr]:
        """The AST value node of a (possibly imported) module-level
        constant, following `from x import NAME` one module deep."""
        if _depth > 4:
            return None
        if name in mod.const_nodes:
            return mod.const_nodes[name]
        if name in mod.from_imports:
            src, orig = mod.from_imports[name]
            target = self._resolve_relative(mod, src)
            if target is not None:
                return self.resolve_constant(target, orig, _depth + 1)
        return None

    def resolve_strings(self, mod: Module, node: ast.expr,
                        local_names: Optional[Dict[str, ast.expr]] = None,
                        _depth: int = 0
                        ) -> Tuple[Set[str], List[str]]:
        """Resolve an expression to the string values it can denote.

        Returns ``(literals, dynamic)``: the statically-known strings
        plus a list of descriptions for the parts that could not be
        resolved (parameter names, attribute chains, calls...). Used
        by the contract rules (schema-drift's bucket expansion,
        scope-registry).
        """
        lits: Set[str] = set()
        dyn: List[str] = []
        if _depth > 6 or node is None:
            return lits, ["<too deep>"] if node is not None else []
        if isinstance(node, ast.Constant):
            if isinstance(node.value, str):
                lits.add(node.value)
            # non-string constants are not names; nothing to check
            return lits, dyn
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            for elt in node.elts:
                sub_l, sub_d = self.resolve_strings(mod, elt, local_names,
                                                   _depth + 1)
                lits |= sub_l
                dyn += sub_d
            return lits, dyn
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
            for side in (node.left, node.right):
                sub_l, sub_d = self.resolve_strings(mod, side, local_names,
                                                    _depth + 1)
                lits |= sub_l
                dyn += sub_d
            return lits, dyn
        if isinstance(node, ast.Name):
            if local_names and node.id in local_names:
                val = local_names[node.id]
                if val is None:   # function parameter: dynamic by name
                    return lits, [node.id]
                return self.resolve_strings(mod, val, local_names,
                                            _depth + 1)
            const = self.resolve_constant(mod, node.id)
            if const is not None:
                return self.resolve_strings(mod, const, None, _depth + 1)
            return lits, [node.id]
        if isinstance(node, ast.Attribute) and isinstance(node.value,
                                                          ast.Name):
            alias = node.value.id
            if alias in mod.imports:
                target = self._resolve_relative(mod, mod.imports[alias])
                if target is not None:
                    const = target.const_nodes.get(node.attr)
                    if const is not None:
                        return self.resolve_strings(target, const, None,
                                                    _depth + 1)
            return lits, [f"{alias}.{node.attr}"]
        if isinstance(node, ast.IfExp):
            for side in (node.body, node.orelse):
                sub_l, sub_d = self.resolve_strings(mod, side, local_names,
                                                    _depth + 1)
                lits |= sub_l
                dyn += sub_d
            return lits, dyn
        return lits, [ast.unparse(node) if hasattr(ast, "unparse")
                      else "<expr>"]

    def resolve_string_tuple(self, mod: Module,
                             name: str) -> Optional[Tuple[str, ...]]:
        """A module-level constant resolved to a flat tuple of
        strings (None when absent or not fully literal) — how the
        rules read the bucket registries."""
        node = self.resolve_constant(mod, name)
        if node is None:
            return None
        lits, dyn = self.resolve_strings(mod, node)
        if dyn:
            return None
        return tuple(sorted(lits))


def function_assigns(func: ast.FunctionDef) -> Dict[str, ast.expr]:
    """name -> value node for the simple assignments and parameters of
    one function body (parameters map to None = dynamic). Nested
    functions are NOT descended into — callers walk the stack."""
    out: Dict[str, ast.expr] = {}
    args = func.args
    for a in (list(args.posonlyargs) + list(args.args)
              + list(args.kwonlyargs)
              + ([args.vararg] if args.vararg else [])
              + ([args.kwarg] if args.kwarg else [])):
        out[a.arg] = None
    stack: List[ast.AST] = list(ast.iter_child_nodes(func))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue  # nested scopes resolve through the caller's stack
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            # first assignment wins; a reassigned name is dynamic
            out[name] = node.value if name not in out else None
        stack.extend(ast.iter_child_nodes(node))
    return out
