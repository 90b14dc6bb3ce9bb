"""The trainer's command line (the JAX package's ``main.py``).

    python -m distributed_tensorflow_example_tpu_torch.main [flags]

The JAX trainer's flag names and defaults (``config.build_train_parser``)
drive ``train/loop.run`` on the card; ``--device cpu`` runs on the CPU.
A flag, value or mode of the JAX trainer that the port does not have yet
exits 2 with a message naming ROADMAP.md.  The operator switches the JAX
``main`` reads from the environment turn flags on as there:
``DTX_METRICS=1`` is ``--metrics``, ``DTX_FLIGHT=1`` is ``--flight`` and
``DTX_STATUS_PORT=P`` is ``--status_port=P`` (gated on the value: a
templated ``DTX_METRICS=0`` stays off, and a flag already given wins).
The JAX platform switch ``DTX_PLATFORM`` is not read: ``--device`` picks
the device.
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
    cfg = apply_env_switches(parse_train_config(argv))
    from .train.loop import run

    try:
        run(cfg)
    except Unported as e:
        print(f"dtx-train (torch): {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
