"""Two host-side choices of the replay and resilience paths, each against
the code without it, in turns within one call.

    python3 scripts/torch_replay_resume_ab.py [--rounds 1] [--out FILE]

- ``engine_yield``: ``chip_smoke.py``'s phase 4g (16 requests at x2, one
  engine twice, then two replicas) with ``DecodeEngine._loop`` as
  committed (it yields the interpreter after each tick) and with the
  loop before that change, reproduced below as ``_loop_without_yield``;
  in the order with, without, without, with (per round).  Per run: the
  most a submit reached the engine behind its schedule (s), tokens/s of
  each replay and the determinism_frac of the two one-engine replays;
- ``reserved_buffers``: phase 5b (the wide MLP under ``--ckpt_every=2``)
  with the trainer's pinned snapshot buffers reserved before the first
  snapshot (``loop._reserve_host_buffers``, as committed) and without
  (the reservation a no-op), in the order with, without, without, with,
  each run in a process of its own (the caching host allocator starts
  empty): the loop's stall of each snapshot (``ckpt_stall_ms``) and the
  writer's mean write ms.

Prints one line per run with the card's name and power limit, and the
runs as JSON to ``--out`` (default ``build/replay_resume_ab.json``).
Needs one card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from distributed_tensorflow_example_tpu_torch.serving import (  # noqa: E402
    engine as engine_lib)
from distributed_tensorflow_example_tpu_torch.train import (  # noqa: E402
    loop as loop_lib)


def _loop_without_yield(self) -> None:
    """``DecodeEngine._loop`` before the yield after each tick."""
    while True:
        with self._work:
            if not self._running:
                return
        try:
            did = self.step()
        except Exception as e:   # noqa: BLE001 — as the engine's own
            if self.engine_retries > 0 and self._recover(e):
                continue
            self._fail(e)
            return
        if not did:
            with self._work:
                if self._running:
                    self._work.wait(timeout=0.02)


def _resilience_run(card: str, variant: str) -> dict:
    """Phase 5b in this process, the reservation as ``variant`` says."""
    if variant == "unreserved":
        loop_lib._reserve_host_buffers = lambda state, dev, sets=3: None
    r = chip_smoke.phase_resilience(card)
    return dict(ab="reserved_buffers", variant=variant,
                stall_ms=r["stall_ms"],
                stall_ms_median=statistics.median(r["stall_ms"]),
                write_ms=r["write_ms"])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out", default="build/replay_resume_ab.json")
    ap.add_argument("--resilience-variant", default="",
                    choices=["", "reserved", "unreserved"],
                    help="run one phase 5b variant and print its row "
                         "(the A/B's child processes)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    card = torch.cuda.get_device_name(0)
    if args.resilience_variant:
        row = _resilience_run(card, args.resilience_variant)
        print("ROW " + json.dumps(row), flush=True)
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    chip_smoke.phase_build()
    committed_loop = engine_lib.DecodeEngine._loop
    runs = []
    for _ in range(args.rounds):
        for variant in ("yield", "no_yield", "no_yield", "yield"):
            engine_lib.DecodeEngine._loop = (
                committed_loop if variant == "yield"
                else _loop_without_yield)
            t0 = time.monotonic()
            r = chip_smoke.phase_replay(card, max_lag_s=float("inf"))
            row = dict(ab="engine_yield", variant=variant,
                       lag_s=r["lag_s"], tps=r["tps"],
                       determinism_frac=r["determinism_frac"],
                       phase_s=time.monotonic() - t0)
            runs.append(row)
            print(f"AB {json.dumps(row)} on {smi}", flush=True)
    engine_lib.DecodeEngine._loop = committed_loop
    for _ in range(args.rounds):
        for variant in ("reserved", "unreserved", "unreserved",
                        "reserved"):
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__),
                 f"--resilience-variant={variant}"],
                capture_output=True, text=True, check=True).stdout
            row = json.loads(next(line[4:] for line in out.splitlines()
                                  if line.startswith("ROW ")))
            runs.append(row)
            print(f"AB {json.dumps(row)} on {smi}", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": smi, "runs": runs}, f, indent=1)
    for ab in ("engine_yield", "reserved_buffers"):
        for variant in sorted({r["variant"] for r in runs
                               if r["ab"] == ab}):
            rows = [r for r in runs if r["ab"] == ab
                    and r["variant"] == variant]
            key = "lag_s" if ab == "engine_yield" else "stall_ms_median"
            print(f"{ab} {variant}: {key} "
                  f"{[round(r[key], 6) for r in rows]} on {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
