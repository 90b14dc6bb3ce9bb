"""The bf16 flash kernels (B5 in both forms, B6, B7) at the trainer's
attention shapes, beside SDPA.

    python3 scripts/torch_flash_bench.py [--root DIR] [--out FILE]

Imports the package and ``chip_smoke.py`` from ``--root`` (default:
this checkout), so the same script times another tree unpacked at DIR:
run two trees in one call in the order A, B, B, A and compare within the
call.  At ``chip_smoke.FLASH_PATH_SHAPES`` ([8, 8192, 8, 128], the
narrow kernels, and [8, 8192, 4, 256], the wide ones), causal bf16, the
rows are ``chip_smoke._flash_timed``'s, as phase 2c reports them: each
kernel's device time between CUDA events with the card kept busy, its
TFLOP/s and bound, its plain version's time at batch 1, SDPA's forward
or backward on the same inputs (the yardstick, never called by the
port), and the largest errors against the plain version over the batch
elements.  This script adds whether two calls give the same bits, and
each form timed again after a pause with the card idle, with the SM
clock before and after: the rows time the four forms back to back, so
each carries the clock the one before it left (a faster forward draws
more power and leaves a lower clock to the dq timed next).

Prints one line per row with the card's name and power limit and
writes the rows to ``--out`` as JSON.  Needs one card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# per shape: the seeds of the plain version's batch-1 inputs and of the
# kernels' full-batch inputs
SEEDS = ((24001, 24002), (24003, 24004))


# seconds the card idles before each form's idle-start timing
PAUSE_S = 3.0


def _calls(smoke, shape, seed: int) -> dict:
    """Per form: the call ``_flash_timed`` times, on its inputs."""
    from distributed_tensorflow_example_tpu_torch.ops import (
        flash_attention as fa)

    q, k, v, do = smoke._flash_inputs(*shape, seed)
    acc, m, l = fa.flash_forward(q, k, v, True, stats=True)
    dlt = torch.sum(do.float() * (acc / l[..., None]).to(q.dtype).float(),
                    dim=-1)
    del acc
    return {"stats": (fa.flash_forward, (q, k, v, True, True)),
            "normalized": (fa.flash_forward, (q, k, v, True)),
            "dq": (fa.flash_dq, (q, k, v, do, m, l, dlt, True)),
            "dkv": (fa.flash_dkv, (q, k, v, do, m, l, dlt, True))}


def _sm_mhz() -> int:
    return int(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])


def idle_start(smoke, shape, seed: int) -> dict:
    """Per form: its time (``event_ms``) when it runs after PAUSE_S s of
    an idle card, and the SM clock just before and just after."""
    calls = _calls(smoke, shape, seed)
    out = {}
    for form, (fn, args) in calls.items():
        torch.cuda.synchronize()
        time.sleep(PAUSE_S)
        before = _sm_mhz()
        ms = smoke.event_ms(fn, args)
        out[form] = dict(ms=ms, sm_mhz_before=before, sm_mhz_after=_sm_mhz())
    del calls
    torch.cuda.empty_cache()
    return out


def bitwise(smoke, shape, seed: int) -> dict:
    """Per form: whether two calls on the inputs ``_flash_timed`` times
    give the same bits."""
    calls = _calls(smoke, shape, seed)
    same = {}
    for form, (fn, args) in calls.items():
        first, again = fn(*args), fn(*args)
        first = first if isinstance(first, tuple) else (first,)
        again = again if isinstance(again, tuple) else (again,)
        same[form] = all(bool(torch.equal(x, y))
                         for x, y in zip(first, again))
        del first, again
    del calls
    torch.cuda.empty_cache()
    return same


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=_HERE)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[bench] {root} on {smi}", flush=True)
    rows = []
    for shape, seeds in zip(chip_smoke.FLASH_PATH_SHAPES, SEEDS):
        errs = {"flash_forward": (0.0, 0.0), "flash_dq": (0.0, 0.0),
                "flash_dkv": (0.0, 0.0)}
        timed = chip_smoke._flash_timed(smi, shape, seeds, errs)
        same = bitwise(chip_smoke, shape, seeds[1])
        idle = idle_start(chip_smoke, shape, seeds[1])
        for row in timed:
            row.update(bitwise_run_to_run=same[row["form"]], card=smi,
                       idle_start=idle[row["form"]])
            print(f"[flash] {row['form']} {row['shape']} bf16 causal: "
                  f"{row['ms']:.4f} ms ({row['tflops']:.1f} TFLOP/s), "
                  f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
                  f"SDPA {row['library_ms']:.4f} ms "
                  f"({row['x_library']:.2f}x), {row['rel_err']:.3g} of "
                  f"scale, bitwise run to run {same[row['form']]} on {smi}",
                  flush=True)
            cold = idle[row["form"]]
            print(f"[flash idle start] {row['form']} {row['shape']}: "
                  f"{cold['ms']:.4f} ms after {PAUSE_S:g} s idle, SM "
                  f"{cold['sm_mhz_before']} -> {cold['sm_mhz_after']} MHz "
                  f"on {smi}", flush=True)
        rows += timed
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(dict(root=root, card=smi, rows=rows), fh, indent=1)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
