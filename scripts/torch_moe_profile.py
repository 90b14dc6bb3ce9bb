"""Where a full-width sparse-MoE training step of the PyTorch port spends
its time.

    python3 scripts/torch_moe_profile.py [--steps 2] [--fp8] [--out FILE]

Builds ``chip_smoke.py``'s MoE configuration on the card (the JAX repo's
``moe_wide`` bench row: E 64, top-1, capacity factor 1.25, causal flash
attention, d_model 1024, 8 heads of 128, 2 blocks, d_ff 2048, S 1024,
bf16 compute, Adam with bf16 moments, batch 32) under ``--grouped_moe``
(``--fp8`` adds ``--fp8_ffn``) and runs the host loop's step exactly as
``train/loop.run`` does — a numpy batch, copied to the card, one step,
the cost fetched — first one warm-up step, then ``--steps`` steps timed
on the host clock, then ``--steps`` more under ``torch.profiler``.
Prints the host wall per step (the unprofiled pass), the device busy
time per step (the sum of CUDA kernel times, profiled pass), the idle
share ``1 - busy / wall``, the kernels by device time, and the device
time per step of each part of the step: the flash kernels (B5-B7), B8's
training form, the expert FFN's backward (plain products), the routing
(router, slotting and scatter) and the combine, the fp8 rounding, and
Adam.  The parts are ``torch.profiler.record_function`` ranges this
script wraps around the port's functions (``_sparse_route``,
``_sparse_combine``, ``_grouped_backward``, ``_fp8_operands``, the
optimizer's ``update``); the port's code carries no instrumentation.
The same numbers go to ``--out`` as JSON.  Needs one card.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

# name fragments of the port's kernels in the profiler's table
OWN_KERNELS = {"flash_fwd_": "flash forward (B5)",
               "flash_dq_": "flash dq (B6)",
               "flash_dkv_kernel": "flash dk/dv (B7)",
               "gemm_bias_act_kernel": "grouped FFN (B8)"}


def _ranged(label: str, fn):
    @functools.wraps(fn)
    def wrapped(*a, **k):
        with record_function(label):
            return fn(*a, **k)
    return wrapped


def _range_device_us(prof, labels) -> dict:
    """Device time under each labelled range (its kernels and its
    children's), summed over the profiled steps."""
    out = dict.fromkeys(labels, 0.0)
    for ev in prof.events():
        if ev.name in out and ev.device_type == DeviceType.CPU:
            out[ev.name] += ev.device_time_total
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--fp8", action="store_true",
                   help="profile the --grouped_moe --fp8_ffn variant")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from torch_serving_profile import _kernel_table, _print

    from distributed_tensorflow_example_tpu_torch.config import (
        parse_train_config)
    from distributed_tensorflow_example_tpu_torch.data import mnist
    from distributed_tensorflow_example_tpu_torch.models import (
        transformer as tfm)
    from distributed_tensorflow_example_tpu_torch.ops import fused
    from distributed_tensorflow_example_tpu_torch.parallel import step
    from distributed_tensorflow_example_tpu_torch.train import loop, optim
    from distributed_tensorflow_example_tpu_torch.train.state import (
        create_train_state)

    variant = ["--grouped_moe"] + (["--fp8_ffn"] if args.fp8 else [])
    out_path = args.out or os.path.join(
        _REPO, "build", "torch_moe_profile" + ("_fp8" if args.fp8 else "")
        + ".json")
    card = torch.cuda.get_device_name(0)
    cfg = parse_train_config(chip_smoke.MOE_WIDE_FLAGS + variant)
    spec = loop.make_spec(cfg)
    ranges = {"routing": (tfm, "_sparse_route"),
              "combine": (tfm, "_sparse_combine"),
              "expert backward": (fused, "_grouped_backward"),
              "fp8 rounding": (fused, "_fp8_operands")}
    for label, (mod, name) in ranges.items():
        setattr(mod, name, _ranged(label, getattr(mod, name)))
    opt = optim.make_optimizer(cfg)
    opt = dataclasses.replace(opt, update=_ranged("adam", opt.update))
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
    labels = [*ranges, "adam"]
    doc = _kernel_table(prof, args.steps, wall)
    # the ranges also appear on the device's timeline (as annotations
    # spanning their kernels): keep kernels only, so nothing counts twice
    doc["kernels"] = [r for r in doc["kernels"] if r["name"] not in labels]
    busy_us = sum(r["device_us_per_tick"] for r in doc["kernels"])
    doc["device_busy_ms_per_tick"] = busy_us / 1e3
    doc["device_idle_share"] = 1 - busy_us / (doc["wall_ms_per_tick"] * 1e3)
    own = {}
    for r in doc["kernels"]:
        for frag, label in OWN_KERNELS.items():
            if frag in r["name"]:
                own[label] = own.get(label, 0.0) + r["device_us_per_tick"]
    parts = {k: v / args.steps
             for k, v in _range_device_us(prof, labels).items()}
    flops = tfm.flops_per_step(spec, cfg.batch_size)
    report = {"card": card, "flags": chip_smoke.MOE_WIDE_FLAGS + variant,
              "step": doc,
              "own_kernels_ms_per_step": {k: v / 1e3
                                          for k, v in own.items()},
              "own_kernels_busy_share": sum(own.values()) / busy_us,
              "parts_ms_per_step": {k: v / 1e3 for k, v in parts.items()},
              "tokens_per_s": cfg.batch_size * spec.seq_len
              / doc["wall_ms_per_tick"] * 1e3,
              "model_tflops_per_s": flops / doc["wall_ms_per_tick"] / 1e9}
    tag = "moe step" + (" fp8" if args.fp8 else "")
    _print(tag, doc, card, top=20)
    for label, us in sorted(own.items(), key=lambda kv: -kv[1]):
        print(f"[{tag}] {label}: {us / 1e3:.3f} ms/step "
              f"({us / busy_us:.3f} of busy)")
    for label, us in sorted(parts.items(), key=lambda kv: -kv[1]):
        print(f"[{tag}] part {label}: {us / 1e3:.3f} ms/step "
              f"({us / busy_us:.3f} of busy)")
    print(f"[{tag}] {report['tokens_per_s']:.0f} tokens/s, "
          f"{report['model_tflops_per_s']:.2f} model TFLOP/s "
          f"({flops / 1e12:.2f} TFLOP/step)")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as fh:
        json.dump(report, fh, indent=1)
    print(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
