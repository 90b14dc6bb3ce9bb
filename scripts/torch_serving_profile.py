"""Where a full-width serving tick of the PyTorch port spends its time.

    python3 scripts/torch_serving_profile.py [--ticks 8] [--out FILE]
        [--kv_quant int8] [--moe] [--spans]

Builds the ``chip_smoke.py`` serving configuration on the card (the
decode bench model: d_model 1024, 8 heads, 4 blocks, d_ff 4096,
seq_len 1024, bf16 compute, f32 params, ``fused_ln`` + ``fp8_ffn``;
``--moe``: ``chip_smoke.MOE_SERVE``, the E 64 MoE lm decoded by dense
dispatch), with int8 pools under ``--kv_quant int8`` and a span
recorder under ``--spans``, admits the same 8 ragged requests, and runs the first tick (the 8
prefills) and then ``--ticks`` decode-only ticks: once timed on the
host clock, then again under ``torch.profiler``.  Prints, per phase:
host wall per tick (the unprofiled pass), device busy time per tick
(the sum of CUDA kernel times, profiled pass), the idle share
``1 - busy / wall``, and the kernels by device time.  The same numbers
go to ``--out`` as JSON.  Needs one card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)


def _kernel_table(prof, ticks: int, wall_s: float) -> dict:
    """Device kernels by device time (CUDA events only: the CPU-side
    ops that launched them would count the same time twice); the idle
    share is against ``wall_s``, the same ticks' wall without the
    profiler."""
    rows = []
    busy_us = 0.0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        busy_us += dev_us
        rows.append({"name": ev.key[:90], "calls": ev.count,
                     "device_us_per_tick": dev_us / ticks})
    rows.sort(key=lambda r: -r["device_us_per_tick"])
    wall_us = wall_s * 1e6 / ticks
    return {"ticks": ticks, "wall_ms_per_tick": wall_us / 1e3,
            "device_busy_ms_per_tick": busy_us / ticks / 1e3,
            "device_idle_share": 1 - busy_us / ticks / wall_us,
            "kernels": rows}


def _print(phase: str, doc: dict, card: str, top: int = 14) -> None:
    print(f"[{phase}] {doc['ticks']} tick(s) on {card}: wall "
          f"{doc['wall_ms_per_tick']:.3f} ms/tick, device busy "
          f"{doc['device_busy_ms_per_tick']:.3f} ms/tick, idle share "
          f"{doc['device_idle_share']:.3f}")
    for r in doc["kernels"][:top]:
        print(f"[{phase}]   {r['device_us_per_tick']:10.1f} us/tick "
              f"{r['calls']:6d} calls  {r['name']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ticks", type=int, default=8)
    ap.add_argument("--kv_quant", default="", choices=["", "int8"])
    ap.add_argument("--moe", action="store_true")
    ap.add_argument("--spans", action="store_true")
    ap.add_argument("--out", default=os.path.join(
        _REPO, "build", "torch_serving_profile.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from distributed_tensorflow_example_tpu_torch.models import (
        transformer as tfm)
    from distributed_tensorflow_example_tpu_torch.serving.engine import (
        DecodeEngine)

    card = torch.cuda.get_device_name(0)
    width = chip_smoke.MOE_SERVE if args.moe else chip_smoke.FULL_WIDTH
    spec = tfm.TransformerSpec(**width, compute_dtype=torch.bfloat16)
    recorder = None
    if args.spans:
        import tempfile

        from distributed_tensorflow_example_tpu_torch.obs.spans import (
            SpanRecorder)

        recorder = SpanRecorder(tempfile.mkdtemp())
    eng = DecodeEngine(spec, tfm.init(spec, seed=0, device="cuda"),
                       page_size=16, max_batch=8, kv_quant=args.kv_quant,
                       recorder=recorder, device="cuda")
    rng = np.random.RandomState(0)
    lens = [int(n) for n in rng.randint(32, 301, size=8)]
    n_new = 2 + args.ticks
    # warm-up request: builds the kernels, loads cuBLAS
    eng.submit(list(range(1, 33)), 2)
    while eng.step():
        pass
    torch.cuda.synchronize()
    prompts = [rng.randint(0, spec.vocab_size, size=n).tolist()
               for n in lens]
    report = {"card": card, "config": dict(
        width, compute_dtype="bfloat16", prompts=lens,
        kv_quant=args.kv_quant, spans=args.spans)}
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def run_batch(profiled: bool):
        """One pass of the batch: (prefill tick wall, decode wall over
        --ticks, the two profiles or None)."""
        for p in prompts:
            eng.submit(p, n_new)
        walls, profs = [], []
        for n in (1, args.ticks):      # the 8 prefills, then decodes
            with (profile(activities=acts) if profiled
                  else contextlib.nullcontext()) as prof:
                t0 = time.monotonic()
                for _ in range(n):
                    eng.step()
                torch.cuda.synchronize()
                walls.append(time.monotonic() - t0)
            profs.append(prof)
        while eng.step():
            pass
        return walls, profs

    walls, _ = run_batch(profiled=False)
    _, profs = run_batch(profiled=True)
    report["prefill_tick"] = _kernel_table(profs[0], 1, walls[0])
    _print("prefill", report["prefill_tick"], card)
    report["decode_ticks"] = _kernel_table(profs[1], args.ticks, walls[1])
    _print("decode", report["decode_ticks"], card)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
