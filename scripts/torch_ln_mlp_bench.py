"""B4 (the LayerNorm backward) and B1's f32 layers, launch by launch.

    python3 scripts/torch_ln_mlp_bench.py [--root DIR] [--out FILE]

Imports the package, and ``chip_smoke.py``'s timers, from ``--root``
(default: this checkout), so the same script times another tree
unpacked at DIR: run two trees in one call in the order A, B, B, A and
compare within the call.  On the card:

- ``ln_bwd``: ``fused.layer_norm_backward`` at the transformer
  trainer's 65,536 x 1024 (x f32 and bf16, dy f32) and at 129 and 1000
  rows: the call's device time (CUDA events around 20 calls, the card
  kept busy from the first, at 65,536 rows; CUDA-graph replays over
  cold inputs below), each of its launches' device time
  (``torch.profiler``, by kernel name), ``F.layer_norm``'s backward
  (f32 x), the plan the wrapper recorded where it records one, the
  largest error of scale against the plain version, and whether dg and
  db are the same bits over two calls;
- ``mlp_f32``: ``fused.mlp_forward`` on the reference MLP (784-100-10,
  sigmoid, f32) at 100 rows (a training step) and 2000 (eval): the
  call's device time (CUDA-graph replays over cold inputs), each layer's
  launch (``torch.profiler``), the ``addmm`` chain's time, the host's
  time to enqueue one call (the mean of 200 calls back to back), the
  plan recorded, the error of scale against the plain version, and
  whether the logits are the same bits over two calls.

Prints one line per row with the card's name and power limit and
writes them to ``--out`` as JSON.  Needs one card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _event_ms(fn, args, reps: int = 20) -> float:
    """Device ms of one ``fn(*args)`` call: a warm-up call, one more
    enqueued before the first CUDA event (so the card is busy while the
    host enqueues the timed calls), then ``reps`` calls between events.
    The script's own, so that two trees are timed alike."""
    fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn(*args)
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _launches_us(fn, args, calls: int = 10) -> dict:
    """{kernel name: device us per call} of ``calls`` calls under the
    profiler, after one call outside it."""
    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(*args)
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        out[ev.key[:80]] = us / calls
    return out


def _rel(got, want) -> float:
    err = float((got.float() - want.float()).abs().max())
    return err / max(float(want.float().abs().max()), 1e-30)


def ln_bwd_rows(card: str) -> list:
    import chip_smoke
    import torch.nn.functional as F

    from distributed_tensorflow_example_tpu_torch.ops import fused

    d = 1024
    rows_out = []
    for rows, dtype in ((65536, torch.float32), (65536, torch.bfloat16),
                        (1000, torch.float32), (129, torch.float32)):
        def make(i, rows=rows, dtype=dtype):
            g_ = torch.Generator(device="cuda").manual_seed(13000 + rows + i)
            x = (2 * torch.randn(rows, d, generator=g_, device="cuda")
                 + 0.5).to(dtype)
            dy = torch.randn(rows, d, generator=g_, device="cuda")
            gam = 1 + 0.1 * torch.randn(d, generator=g_, device="cuda")
            return dy, x, gam

        esz = torch.tensor([], dtype=dtype).element_size()
        nbytes = rows * d * (4 + esz + 4) + 3 * d * 4
        big = rows >= 65536
        sets = [make(0)] if big else chip_smoke.copies(make, nbytes)
        args = sets[0]
        got = fused.layer_norm_backward(*args)
        again = fused.layer_norm_backward(*args)
        want = fused.layer_norm_backward_reference(*args)
        torch.cuda.synchronize()
        err = max(_rel(a, b) for a, b in zip(got, want))
        bitwise = bool(torch.equal(got[1], again[1])
                       and torch.equal(got[2], again[2])
                       and torch.equal(got[0], again[0]))
        ms = (_event_ms(fused.layer_norm_backward, args) if big
              else chip_smoke.device_ms(fused.layer_norm_backward, sets))
        row = dict(rows=rows, d=d, dtype=str(dtype).split(".")[-1], ms=ms,
                   bound_ms=nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3,
                   launches_us=_launches_us(fused.layer_norm_backward, args),
                   plan=getattr(fused.layer_norm_backward, "last_plan", None),
                   rel_err=err, bitwise_run_to_run=bitwise)
        if dtype == torch.float32 and big:
            dy, x, gam = args
            xg = x.detach().requires_grad_(True)
            gg = gam.detach().requires_grad_(True)
            bg = torch.zeros(d, device="cuda", requires_grad=True)
            y = F.layer_norm(xg, (d,), gg, bg, eps=fused.LN_EPS)
            row["library_ms"] = _event_ms(
                lambda: torch.autograd.grad(y, (xg, gg, bg), dy,
                                            retain_graph=True), ())
            del xg, gg, bg, y
        del sets, args, got, again, want
        torch.cuda.empty_cache()
        print(f"[ln_bwd] {rows} x {d} {row['dtype']}: {ms:.5f} ms (bound "
              f"{row['bound_ms']:.5f}, {row['bound_ms'] / ms:.1%}), library "
              f"{row.get('library_ms')} ms, plan {row['plan']}, launches "
              + ", ".join(f"{k} {v:.2f} us" for k, v in
                          row["launches_us"].items())
              + f"; {err:.3g} of scale, bitwise run to run {bitwise} on "
              f"{card}", flush=True)
        rows_out.append(row)
    return rows_out


def mlp_f32_rows(card: str) -> list:
    import chip_smoke

    from distributed_tensorflow_example_tpu_torch.models import mlp
    from distributed_tensorflow_example_tpu_torch.ops import fused

    spec = mlp.MLPSpec(hidden_sizes=(100,), activation="sigmoid",
                       compute_dtype=torch.float32)
    sizes = spec.layer_sizes
    rows_out = []
    for n in (100, 2000):
        def make(i, n=n):
            g = torch.Generator(device="cuda").manual_seed(9000 + n + i)
            p = {}
            for j in range(1, spec.num_layers + 1):
                p[f"W{j}"] = torch.randn(sizes[j - 1], sizes[j], generator=g,
                                         device="cuda")
                p[f"b{j}"] = 0.1 * torch.randn(sizes[j], generator=g,
                                               device="cuda")
            x = torch.rand(n, sizes[0], generator=g, device="cuda")
            return (spec, p, x)

        nbytes = 4 * (n * sizes[0] + sizes[0] * sizes[1] + sizes[1] * sizes[2]
                      + n * sizes[1] + n * sizes[2])
        sets = chip_smoke.copies(make, nbytes)

        def addmm(spec_, p, x):
            h = torch.sigmoid(torch.addmm(p["b1"], x, p["W1"]))
            return torch.addmm(p["b2"], h, p["W2"])

        with torch.no_grad():
            got = fused.mlp_forward(*sets[0])
            again = fused.mlp_forward(*sets[0])
            want = fused.mlp_forward_reference(*sets[0])[0]
            torch.cuda.synchronize()
            ms = chip_smoke.device_ms(fused.mlp_forward, sets)
            lib_ms = chip_smoke.device_ms(addmm, sets)
            layers = _launches_us(fused.mlp_forward, sets[0], 20)
            fused.mlp_forward(*sets[0])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                fused.mlp_forward(*sets[0])
            host_us = (time.perf_counter() - t0) / 200 * 1e6
            torch.cuda.synchronize()
        row = dict(rows=n, sizes=list(sizes), ms=ms, library_ms=lib_ms,
                   x_library=ms / lib_ms, launches_us=layers,
                   host_enqueue_us=host_us,
                   plan=getattr(fused.mlp_forward, "last_plan", None),
                   rel_err=_rel(got, want),
                   bitwise_run_to_run=bool(torch.equal(got, again)))
        print(f"[mlp_f32] {n} rows {'-'.join(map(str, sizes))} sigmoid: "
              f"{ms:.5f} ms, addmm chain {lib_ms:.5f} ms ({row['x_library']:.2f}"
              f"x), enqueue {host_us:.1f} us, plan {row['plan']}, launches "
              + ", ".join(f"{k} {v:.2f} us" for k, v in layers.items())
              + f"; {row['rel_err']:.3g} of scale, bitwise run to run "
              f"{row['bitwise_run_to_run']} on {card}", flush=True)
        rows_out.append(row)
    return rows_out


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
    card = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[bench] {root} on {smi}", flush=True)
    report = dict(root=root, card=smi, ln_bwd=ln_bwd_rows(card),
                  mlp_f32=mlp_f32_rows(card))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=1)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
