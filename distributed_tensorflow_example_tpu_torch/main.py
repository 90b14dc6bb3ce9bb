"""The trainer's command line (the JAX package's ``main.py``).

    python -m distributed_tensorflow_example_tpu_torch.main [flags]

The JAX trainer's flag names and defaults (``config.build_train_parser``)
drive ``train/loop.run`` on the card; ``--device cpu`` runs on the CPU.
A flag, value or mode of the JAX trainer that the port does not have yet
exits 2 with a message naming ROADMAP.md, and so do the operator switches
the JAX ``main`` reads from the environment (``DTX_METRICS``,
``DTX_FLIGHT``, ``DTX_STATUS_PORT``).  The JAX platform switch
``DTX_PLATFORM`` is not read: ``--device`` picks the device.
"""

from __future__ import annotations

import os
import sys

from .config import Unported, parse_train_config


def _env_flag(name: str) -> bool:
    return (os.environ.get(name, "").strip().lower()
            in ("1", "true", "yes", "on"))


def main(argv=None) -> int:
    cfg = parse_train_config(argv)
    refused = [name for name in ("DTX_METRICS", "DTX_FLIGHT")
               if _env_flag(name)]
    port = os.environ.get("DTX_STATUS_PORT", "").strip()
    if port.isdigit() and int(port):
        refused.append("DTX_STATUS_PORT")
    if refused:
        print(f"dtx-train (torch): {', '.join(refused)} not ported to the "
              f"PyTorch trainer yet (see ROADMAP.md Queue A)",
              file=sys.stderr)
        return 2
    from .train.loop import run

    try:
        run(cfg)
    except Unported as e:
        print(f"dtx-train (torch): {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
