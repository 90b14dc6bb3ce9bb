"""Host cost of the port's host-bound paths, to compare two trees.

    python3 scripts/torch_host_cost.py [--root DIR] [--repeats 3] [--out FILE]

Imports the package, and ``chip_smoke.py``'s configurations, from
``--root`` (default: this checkout), so the same script times another
tree unpacked at DIR.  Run it on two trees in one call, in the order A,
B, B, A, and compare within the call.  On the card:

- ``cpu``: a fixed host workload (2000 small CPU tensor additions and a
  pure-Python loop), ms: the host's own speed in this run, since the
  rows below are host-bound and a one-card machine shares its host's
  cores;
- ``b8_enqueue_us``: B8 (``moe_grouped_matmul``) at the serve's decode
  shape (E 1, C 8, d 1024, ff 4096, bf16, gelu): the host's time to
  enqueue one call (the mean of 200 calls back to back, no profiler),
  one reading per repeat;
- ``b8_c_us``: where the tree plans B8's launches
  (``fused.grouped_ffn_plan``), the part of that time spent in the C
  entry point (the tensor maps and the launches, through ctypes), with
  the wrapper's checks and allocations done once beforehand;
- ``serve``: the serve of ``chip_smoke.py`` (its FULL_WIDTH model, 8
  ragged requests, 32 new tokens): decode ms per tick (median) and
  tokens/s, one reading per repeat after a warm-up run;
- ``mlp_step_ms``: the wide MLP trainer of ``chip_smoke.py``
  (WIDE_TRAIN, one epoch of 8 steps): the median step, one reading per
  repeat after a warm-up run.

Prints one line per reading with the card's name and power limit and
writes them to ``--out`` as JSON.  Needs one card.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch


def _cpu_ms() -> float:
    a, b = torch.ones(64), torch.ones(64)
    t0 = time.perf_counter()
    for _ in range(2000):
        torch.add(a, b)
    total = 0
    for i in range(200_000):
        total += i
    return (time.perf_counter() - t0) * 1e3


def _b8_operands():
    g = torch.Generator(device="cuda").manual_seed(7)
    bf16 = torch.bfloat16
    e, c, d, ff = 1, 8, 1024, 4096
    return ("gelu", bf16,
            torch.randn(e, c, d, generator=g, device="cuda").to(bf16),
            (torch.randn(e, d, ff, generator=g, device="cuda") / 32).to(bf16),
            0.1 * torch.randn(e, ff, generator=g, device="cuda"),
            (torch.randn(e, ff, d, generator=g, device="cuda") / 64).to(bf16),
            0.1 * torch.randn(e, d, generator=g, device="cuda"))


def _per_call_us(fn, calls: int = 200) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def _b8_c_call(fused, args):
    """The C entry point of B8's primal form with the wrapper's own
    arguments, its tensors allocated once."""
    _act, cdt, x, w1, b1, w2, b2 = args
    e, c, d = x.shape
    ff = w1.shape[-1]
    plan = fused.grouped_ffn_plan(e, c, d, ff, torch.cuda.get_device_properties(
        0).multi_processor_count)
    h1 = torch.empty((e, c, ff), dtype=cdt, device="cuda")
    out = torch.empty((e, c, d), dtype=torch.float32, device="cuda")
    shares = max(plan[0][1] * ff if plan[0][1] > 1 else 0,
                 plan[1][1] * d if plan[1][1] > 1 else 0)
    part = torch.empty((max(shares, 1) * e * c,), dtype=torch.float32,
                       device="cuda")
    ptrs = [t.data_ptr() for t in (x, w1, b1, w2, b2, h1, out)]

    def call():
        fused._launch("dtx_grouped_ffn_fwd", *ptrs, None,
                      part.data_ptr() if shares else None, e, c, d, ff, 0,
                      1, *plan[0], *plan[1])
    return call


def _serve_once(smoke):
    from distributed_tensorflow_example_tpu_torch.models import (
        transformer as tfm)
    from distributed_tensorflow_example_tpu_torch.serving.engine import (
        DecodeEngine)

    spec = tfm.TransformerSpec(**smoke.FULL_WIDTH,
                               compute_dtype=torch.bfloat16)
    params = tfm.init(spec, seed=0, device="cuda")
    eng = DecodeEngine(spec, params, page_size=16, max_batch=8,
                       device="cuda")
    rng = np.random.RandomState(0)
    lo, hi = 32 * spec.seq_len // 1024, 300 * spec.seq_len // 1024
    lens = [int(n) for n in rng.randint(lo, hi + 1, size=8)]
    n_new = 32 * spec.seq_len // 1024
    prompts = [rng.randint(0, spec.vocab_size, size=n).tolist()
               for n in lens]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    rids = [eng.submit(p, n_new) for p in prompts]
    tick_s = []
    while True:
        ts = time.monotonic()
        if not eng.step():
            break
        tick_s.append(time.monotonic() - ts)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    toks = sum(len(eng.result(r, timeout=0)["tokens"]) for r in rids)
    return dict(decode_ms_per_tick=float(np.median(tick_s[1:])) * 1e3,
                tokens_per_s=toks / wall, ticks=len(tick_s))


def _mlp_step_ms(smoke) -> float:
    from distributed_tensorflow_example_tpu_torch.config import Config
    from distributed_tensorflow_example_tpu_torch.train import loop

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        loop.run(Config(**smoke.WIDE_TRAIN, device="cuda"))
    steps = [float(m) for m in re.findall(r"AvgTime: +(\d+\.\d+)ms",
                                          buf.getvalue())]
    return statistics.median(steps)


def main(argv=None) -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=here)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke as smoke
    from distributed_tensorflow_example_tpu_torch.ops import fused

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    report = dict(root=root, card=card, cpu_ms=[], b8_enqueue_us=[],
                  b8_c_us=[], serve=[], mlp_step_ms=[])
    b8 = _b8_operands()
    c_call = (_b8_c_call(fused, b8) if hasattr(fused, "grouped_ffn_plan")
              else None)
    _serve_once(smoke)                       # warm-up: build, first calls
    _mlp_step_ms(smoke)
    for _ in range(args.repeats):
        report["cpu_ms"].append(_cpu_ms())
        report["b8_enqueue_us"].append(
            _per_call_us(lambda: fused.moe_grouped_matmul(*b8)))
        if c_call is not None:
            report["b8_c_us"].append(_per_call_us(c_call))
        report["serve"].append(_serve_once(smoke))
        report["mlp_step_ms"].append(_mlp_step_ms(smoke))
    print(f"[host] {root} on {card}: cpu {report['cpu_ms']} ms; B8 decode "
          f"call enqueue {report['b8_enqueue_us']} us, of which the C entry "
          f"point {report['b8_c_us']} us; serve decode "
          f"{[s['decode_ms_per_tick'] for s in report['serve']]} ms/tick, "
          f"{[s['tokens_per_s'] for s in report['serve']]} tokens/s; MLP "
          f"step {report['mlp_step_ms']} ms", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
