"""dtx-lint for the port: repo-aware static analysis of the PyTorch
package's SPMD, schema and host-sync contracts (the JAX package's
``analysis`` in torch form; the JAX one looks only for ``lax.*`` and
``jax.*`` and cannot see this package):

- ``group=`` at ``torch.distributed`` collectives (and ``cluster``'s
  wrappers) vs the ``Mesh`` groups; a collective with none runs over
  the world;
- host syncs (``.item()``, ``.cpu()``, ``synchronize()``...) sneaking
  into ``train/loop.py``'s step window;
- written telemetry keys vs the ``obs/schema.py`` contracts;
- ``torch.autograd.Function`` subclasses without a static backward,
  one gradient per input, or a read of what forward saved;
- CUDA graphs, ``torch.compile`` and TorchScript built inside a loop;
  draws from a global RNG anywhere (the port's contract is explicit
  generators);
- CLI flags vs ``docs/API.md`` (``--device`` vs the README's port
  section), ``dtx_*`` gauges vs ``docs/observability.md``;
- trace-scope/bucket literals vs the ``obs/buckets.py`` registry.

Pure stdlib + ``ast``: the rules never import or run anything of the
linted tree (the port's own ``__init__`` imports torch, so ``python -m``
pays for that import; the rules do not use it).

Layout: ``index`` (shared parsed-module index every rule visits),
``findings`` (Finding + baseline handling), ``rules_spmd`` /
``rules_loop`` / ``rules_contracts`` (the rule visitors), ``cli``
(``python -m distributed_tensorflow_example_tpu_torch.analysis.cli``).
Suppression: ``# dtx: noqa[rule] reason`` on the finding's line.
"""

from .findings import Finding  # noqa: F401
from .index import ModuleIndex  # noqa: F401
