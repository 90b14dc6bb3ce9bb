"""The PyTorch port imports neither JAX nor the JAX package.

A subprocess imports every module of the port (and ``chip_smoke.py``)
with ``jax``, ``jaxlib`` and ``distributed_tensorflow_example_tpu``
poisoned in ``sys.modules`` — any import of them raises — and a source
scan finds no such import statement in the port.
"""

import os
import re
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PORT = os.path.join(_REPO, "distributed_tensorflow_example_tpu_torch")


def _port_modules():
    mods = []
    for root, _dirs, files in os.walk(_PORT):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), _REPO)[:-3]
                mod = rel.replace(os.sep, ".")
                mods.append(mod[:-len(".__init__")]
                            if mod.endswith(".__init__") else mod)
    return sorted(mods)


def test_port_imports_with_jax_and_the_jax_package_poisoned():
    mods = _port_modules() + ["chip_smoke"]
    assert len(mods) >= 15
    assert "distributed_tensorflow_example_tpu_torch.parallel.local_sgd" \
        in mods
    assert {f"distributed_tensorflow_example_tpu_torch.obs.{m}" for m in
            ("cli", "compare", "history", "drift", "capacity")} <= set(mods)
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'distributed_tensorflow_example_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'distributed_tensorflow_example_tpu') "
        "and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=_REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_no_port_source_names_jax_or_the_jax_package():
    pat = re.compile(
        r"^\s*(import\s+jax\b|from\s+jax\b|import\s+jaxlib\b|"
        r"from\s+jaxlib\b|import\s+distributed_tensorflow_example_tpu\b"
        r"(?!_torch)|from\s+distributed_tensorflow_example_tpu\b(?!_torch)"
        r"|from\s+\.\.\.)", re.M)
    files = [os.path.join(r, f) for r, _d, fs in os.walk(_PORT)
             for f in fs if f.endswith(".py")]
    files.append(os.path.join(_REPO, "chip_smoke.py"))
    hits = {}
    for path in files:
        with open(path) as fh:
            found = pat.findall(fh.read())
        if found:
            hits[os.path.relpath(path, _REPO)] = found
    assert not hits, hits
