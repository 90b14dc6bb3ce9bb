"""Where a full-width training step of the PyTorch port spends its time.

    python3 scripts/torch_training_profile.py [--steps 6] [--out FILE]

Builds ``chip_smoke.py``'s full-width trainer configuration on the card
(the JAX repo's ``mxu_wide_pallas`` bench row: 784-4096-4096-10, relu,
bf16 compute over f32 params, global batch 8192, ``--pallas``, SGD) and
runs the host loop's step exactly as ``train/loop.run`` does — a numpy
batch from ``EpochIterator``, copied to the card, one step, the cost
fetched — first for two warm-up steps, then ``--steps`` steps timed on
the host clock, then ``--steps`` more under ``torch.profiler``.  Prints
the host wall per step (the unprofiled pass), the device busy time per
step (the sum of CUDA kernel times, profiled pass), the idle share
``1 - busy / wall``, and the kernels by device time; the same numbers go
to ``--out`` as JSON.  Needs one card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--out", default=os.path.join(
        _REPO, "build", "torch_training_profile.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from torch_serving_profile import _kernel_table, _print

    from distributed_tensorflow_example_tpu_torch.config import Config
    from distributed_tensorflow_example_tpu_torch.data import mnist
    from distributed_tensorflow_example_tpu_torch.parallel import step
    from distributed_tensorflow_example_tpu_torch.train import loop, optim
    from distributed_tensorflow_example_tpu_torch.train.state import (
        create_train_state)

    card = torch.cuda.get_device_name(0)
    cfg = Config(**chip_smoke.WIDE_TRAIN, device="cuda")
    spec = loop.make_spec(cfg)
    opt = optim.make_optimizer(cfg)
    body = step.make_sync_step_body(cfg, spec, opt)
    state = create_train_state(spec, opt, seed=cfg.seed, device="cuda")
    n_steps = 2 + 2 * args.steps
    data = mnist.synthesize_split(n_steps * cfg.batch_size, seed=1)
    batches = iter(mnist.EpochIterator(data, cfg.batch_size,
                                       seed=cfg.seed).epoch(0))

    def steps(n: int) -> float:
        """``n`` host-loop steps; their wall on the host clock."""
        nonlocal state
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(n):
            bx, by = next(batches)
            x = torch.from_numpy(bx).to("cuda")
            y = torch.from_numpy(by).to("cuda")
            state, cost, _acc = body(state, x, y)
            float(cost)       # the loop's per-print fetch (frequency 1)
        torch.cuda.synchronize()
        return time.monotonic() - t0

    steps(2)                                  # builds kernels, cuBLAS
    wall = steps(args.steps)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        steps(args.steps)
    doc = _kernel_table(prof, args.steps, wall)
    doc["ticks"] = args.steps
    report = {"card": card, "config": {k: (list(v) if isinstance(v, tuple)
                                           else v)
                                       for k, v in
                                       chip_smoke.WIDE_TRAIN.items()},
              "step": doc,
              "examples_per_s": cfg.batch_size / doc["wall_ms_per_tick"]
              * 1e3}
    _print("train step", doc, card)
    print(f"[train step] {report['examples_per_s']:.1f} examples/s at "
          f"global batch {cfg.batch_size}")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
