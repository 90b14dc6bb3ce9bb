"""Where B8, the grouped expert FFN, spends its time, launch by launch.

    python3 scripts/torch_grouped_ffn_profile.py [--calls 5] [--out FILE]

On the card, at the paths' shapes in bf16 (the operands as the paths
hand them over: bf16 buffer and weights, f32 biases):

- the ``moe_wide`` trainer's [64, 640, 1024] x ff 2048, in the training
  form (``moe_grouped_matmul_z1``) and the primal form, each with gelu
  (the path's activation) and with relu (whose epilogue costs almost
  nothing, so the difference is gelu's share of the epilogue);
- the serve's decode (E 1, C 8) and prefill (E 1, C 512) rows at d 1024,
  ff 4096, primal form.

Each case runs ``--calls`` calls under ``torch.profiler`` after one
warm-up call and prints the device time per call of each kernel launch
(the tensor-core products, named by their output type, tile width and
z1 store, and the split-K sums), the launch plan and the TFLOP/s of the
whole call; then the host's time to enqueue one call (the wrapper's
checks, allocations and plan, the tensor maps and the launches; no
profiler, the mean of 200 calls enqueued back to back), which bounds the
serve's ticks, whose host side is the larger part.  The same numbers go
to ``--out`` as JSON.  Needs one card.
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

# (label, E, C, d, ff, activation, training form)
CASES = [
    ("moe_wide z1 gelu", 64, 640, 1024, 2048, "gelu", True),
    ("moe_wide primal gelu", 64, 640, 1024, 2048, "gelu", False),
    ("moe_wide z1 relu", 64, 640, 1024, 2048, "relu", True),
    ("moe_wide primal relu", 64, 640, 1024, 2048, "relu", False),
    ("decode primal gelu", 1, 8, 1024, 4096, "gelu", False),
    ("prefill primal gelu", 1, 512, 1024, 4096, "gelu", False),
]


def _operands(e, c, d, ff, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    bf16 = torch.bfloat16
    return (torch.randn(e, c, d, generator=g, device="cuda").to(bf16),
            (torch.randn(e, d, ff, generator=g, device="cuda")
             / d ** 0.5).to(bf16),
            0.1 * torch.randn(e, ff, generator=g, device="cuda"),
            (torch.randn(e, ff, d, generator=g, device="cuda")
             / ff ** 0.5).to(bf16),
            0.1 * torch.randn(e, d, generator=g, device="cuda"))


def _launches(prof, calls: int) -> list:
    """[(kernel name, launches per call, device us per call)] of the
    device kernels under the profiler, largest first."""
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        rows.append((ev.key[:100], ev.count / calls, us / calls))
    return sorted(rows, key=lambda r: -r[2])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--out", default=os.path.join(
        _REPO, "build", "torch_grouped_ffn_profile.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from distributed_tensorflow_example_tpu_torch.ops import fused

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    report = {"card": card, "cases": []}
    for label, e, c, d, ff, act, z1 in CASES:
        ops = _operands(e, c, d, ff, seed=e + c)
        fn = fused.moe_grouped_matmul_z1 if z1 else fused.moe_grouped_matmul
        fn(act, torch.bfloat16, *ops)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.calls):
                fn(act, torch.bfloat16, *ops)
            torch.cuda.synchronize()
        rows = _launches(prof, args.calls)
        n_host = 200
        t0 = time.perf_counter()
        for _ in range(n_host):
            fn(act, torch.bfloat16, *ops)
        host_us = (time.perf_counter() - t0) / n_host * 1e6
        torch.cuda.synchronize()
        total_us = sum(us for _n, _k, us in rows)
        flops = 4 * e * c * d * ff
        plan = fused.grouped_ffn_plan(e, c, d, ff, sms)
        case = dict(label=label, experts=e, rows=c, d=d, ff=ff,
                    activation=act, z1=z1, plan=plan,
                    device_us_per_call=total_us, host_us_per_call=host_us,
                    tflops=flops / total_us / 1e6,
                    launches=[dict(kernel=n, per_call=k, device_us=us)
                              for n, k, us in rows])
        report["cases"].append(case)
        print(f"[b8] {label} [{e}, {c}, {d}] x {ff}, plan {plan}: "
              f"{total_us:.1f} us a call, {case['tflops']:.1f} TFLOP/s, "
              f"host {host_us:.1f} us to enqueue a call on {card}",
              flush=True)
        for n, k, us in rows:
            print(f"[b8]   {us:10.1f} us  x{k:g}  {n}", flush=True)
        del ops
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
