"""Where a full-width transformer training step of the PyTorch port
spends its time.

    python3 scripts/torch_transformer_profile.py [--steps 2] [--wide-heads]
        [--root DIR] [--out FILE]

Builds ``chip_smoke.py``'s transformer configuration on the card (the
JAX repo's ``transformer_wide_long`` bench row: causal flash attention,
``--fused_ln``, d_model 1024, 8 heads of 128, 4 blocks, d_ff 4096,
S 8192, bf16 compute, Adam with bf16 moments, batch 8; with
``--wide-heads`` phase 7c's form of it, 4 heads of 256, which runs the
flash kernels' wide instantiations) and runs the host
loop's step exactly as ``train/loop.run`` does — a numpy batch from
``EpochIterator``, copied to the card, one step, the cost fetched —
first one warm-up step, then ``--steps`` steps timed on the host clock,
then ``--steps`` more under ``torch.profiler``.  Prints the host wall
per step (the unprofiled pass), the device busy time per step (the sum
of CUDA kernel times, profiled pass), the idle share ``1 - busy /
wall``, the kernels by device time, and the share of the busy time in
the port's own kernels (flash forward, dq, dk/dv, the LayerNorms); the
same numbers go to ``--out`` as JSON.  ``--root`` imports the package
and ``chip_smoke.py`` from another tree unpacked at DIR, so two trees
can be profiled in one call.  Needs one card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

# name fragments of the port's kernels in the profiler's table
OWN_KERNELS = {"flash_fwd_": "flash forward (B5)",
               "flash_dq_": "flash dq (B6)",
               "flash_dkv_": "flash dk/dv (B7)",
               "ln_bwd": "LayerNorm backward (B4)",
               "ln_fwd_": "LayerNorm forward (B2, B3)"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--wide-heads", action="store_true",
                    help="4 heads of 256 (chip_smoke.py phase 7c)")
    ap.add_argument("--root", default=_REPO)
    ap.add_argument("--out", default=os.path.join(
        _REPO, "build", "torch_transformer_profile.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    # torch_serving_profile puts this tree first on the path: import it
    # before the tree under --root goes in front
    from torch_serving_profile import _kernel_table, _print
    sys.path.insert(0, os.path.abspath(args.root))
    import chip_smoke

    from distributed_tensorflow_example_tpu_torch.config import (
        parse_train_config)
    from distributed_tensorflow_example_tpu_torch.data import mnist
    from distributed_tensorflow_example_tpu_torch.models import (
        transformer as tfm)
    from distributed_tensorflow_example_tpu_torch.parallel import step
    from distributed_tensorflow_example_tpu_torch.train import loop, optim
    from distributed_tensorflow_example_tpu_torch.train.state import (
        create_train_state)

    # the card's name and power limit, beside every number printed
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    flags = (chip_smoke.WIDE_HEAD_FLAGS if args.wide_heads
             else chip_smoke.WIDE_LONG_FLAGS)
    cfg = parse_train_config(flags)
    spec = loop.make_spec(cfg)
    opt = optim.make_optimizer(cfg)
    body = step.make_sync_step_body(cfg, spec, opt)
    state = create_train_state(spec, opt, seed=cfg.seed, device="cuda")
    n_steps = 1 + 2 * args.steps
    data = mnist.synthesize_split(n_steps * cfg.batch_size, seed=1,
                                  input_size=cfg.input_size)
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

    steps(1)                                  # builds kernels, cuBLAS
    wall = steps(args.steps)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        steps(args.steps)
    doc = _kernel_table(prof, args.steps, wall)
    busy_us = doc["device_busy_ms_per_tick"] * 1e3
    own = {}
    for r in doc["kernels"]:
        for frag, label in OWN_KERNELS.items():
            if frag in r["name"]:
                own[label] = own.get(label, 0.0) + r["device_us_per_tick"]
    flops = tfm.flops_per_step(spec, cfg.batch_size)
    report = {"card": card, "root": os.path.abspath(args.root),
              "flags": flags,
              "step": doc,
              "own_kernels_ms_per_step": {k: v / 1e3
                                          for k, v in own.items()},
              "own_kernels_busy_share": sum(own.values()) / busy_us,
              "tokens_per_s": cfg.batch_size * spec.seq_len
              / doc["wall_ms_per_tick"] * 1e3,
              "model_tflops_per_s": flops / doc["wall_ms_per_tick"] / 1e9}
    _print("tfm step", doc, card, top=16)
    for label, us in sorted(own.items(), key=lambda kv: -kv[1]):
        print(f"[tfm step] {label}: {us / 1e3:.2f} ms/step "
              f"({us / busy_us:.3f} of busy)")
    print(f"[tfm step] {report['tokens_per_s']:.0f} tokens/s, "
          f"{report['model_tflops_per_s']:.2f} model TFLOP/s "
          f"({flops / 1e12:.2f} TFLOP/step)")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
