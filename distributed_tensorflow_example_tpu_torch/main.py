"""The trainer's command line (the JAX package's ``main.py``).

    python -m distributed_tensorflow_example_tpu_torch.main [flags]

The JAX trainer's flag names and defaults (``config.build_train_parser``)
drive ``train/loop.run`` on the card; ``--device cpu`` runs on the CPU.
A flag, value or mode of the JAX trainer that the port does not have yet
exits 2 with a message naming ROADMAP.md, and a combination of flags or
a layout the JAX trainer refuses (``train/loop.preflight``) exits 2 with
JAX's message, before any process group or data.  The operator
switches the JAX ``main`` reads from the environment turn flags on as
there:
``DTX_METRICS=1`` is ``--metrics``, ``DTX_FLIGHT=1`` is ``--flight`` and
``DTX_STATUS_PORT=P`` is ``--status_port=P`` (gated on the value: a
templated ``DTX_METRICS=0`` stays off, and a flag already given wins).
The JAX platform switch ``DTX_PLATFORM`` is not read: ``--device`` picks
the device.  ``--compilation_cache`` is accepted and explained away with
a one-line NOTE, as ``--job_name=ps`` is (``cluster.py``).
"""

from __future__ import annotations

import dataclasses
import os
import sys

from .config import Config, Unported, parse_train_config


def _env_flag(name: str) -> bool:
    return (os.environ.get(name, "").strip().lower()
            in ("1", "true", "yes", "on"))


def apply_env_switches(cfg: Config) -> Config:
    """``cfg`` with the ``DTX_METRICS``, ``DTX_FLIGHT`` and
    ``DTX_STATUS_PORT`` switches applied, as the JAX ``main`` applies
    them."""
    for env_name, field in (("DTX_METRICS", "metrics"),
                            ("DTX_FLIGHT", "flight")):
        if _env_flag(env_name) and not getattr(cfg, field):
            cfg = dataclasses.replace(cfg, **{field: True})
    port = os.environ.get("DTX_STATUS_PORT", "").strip()
    if port.isdigit() and int(port) and not cfg.status_port:
        cfg = dataclasses.replace(cfg, status_port=int(port))
    return cfg


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    cfg = apply_env_switches(parse_train_config(argv))
    from .cluster import COMPILATION_CACHE_NOTE
    from .train.loop import preflight, run

    if any(a.split("=", 1)[0] == "--compilation_cache" for a in argv):
        print(COMPILATION_CACHE_NOTE)

    try:
        preflight(cfg)
    except ValueError as e:
        # a refused flag, combination or layout, before any training
        print(f"dtx-train (torch): {e}", file=sys.stderr)
        return 2
    try:
        run(cfg)
    except Unported as e:
        print(f"dtx-train (torch): {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
