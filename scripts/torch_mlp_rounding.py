"""How far apart B1 (the MLP forward kernel) and its plain version may
land in bf16, and why.

    python3 scripts/torch_mlp_rounding.py [--out FILE]

Two parts, on the card:

1. three ways to multiply bf16 operands into an f32 result — ``torch.mm
   (..., out_dtype=torch.float32)`` (bf16 tensor cores; the route
   ``models.mlp.dot_f32`` takes on the card), the operands upcast to
   f32 without TF32 (the route it takes on the CPU), and upcast with
   TF32 on (exact for bf16 operands) — each against an f64 product
   (largest error relative to the largest magnitude) and timed with
   CUDA events, at the wide trainer's three product shapes;
2. the wide trainer's forward (8192 rows, 784-4096-4096-10, relu, bf16)
   through the kernel and through the plain layer chain with each route:
   the logits' largest difference relative to their scale, the number
   of hiddens that round to another bf16 value, and the logits layer
   alone on the kernel's own last hidden.

Prints one line per measurement and writes them to ``--out`` as JSON.
Needs one card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)


def _ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _tf32(a, b):
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return a.float() @ b.float()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


ROUTES = {
    "mm_out_dtype": lambda a, b: torch.mm(a, b, out_dtype=torch.float32),
    "f32": lambda a, b: a.float() @ b.float(),
    "tf32": _tf32,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        _REPO, "build", "torch_mlp_rounding.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from distributed_tensorflow_example_tpu_torch.models import mlp
    from distributed_tensorflow_example_tpu_torch.ops import _build, fused

    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(0)
    report = {"routes": [], "b1_wide": []}
    for m, k, n in [(8192, 784, 4096), (8192, 4096, 4096), (8192, 4096, 10)]:
        a = torch.randn(m, k, generator=gen, device="cuda").to(bf16)
        b = torch.randn(k, n, generator=gen, device="cuda").to(bf16)
        exact = a.double() @ b.double()
        scale = float(exact.abs().max())
        for name, fn in ROUTES.items():
            r = fn(a, b)
            row = dict(shape=[m, k, n], route=name, out_dtype=str(r.dtype),
                       rel_err=float((r.double() - exact).abs().max())
                       / scale, ms=_ms(lambda: fn(a, b)))
            print(f"[route] {m}x{k}x{n} {name}: {row['out_dtype']}, max "
                  f"|r - f64| {row['rel_err']:.3e} of scale, "
                  f"{row['ms']:.4f} ms", flush=True)
            report["routes"].append(row)

    _build.load()
    spec = mlp.MLPSpec(hidden_sizes=(4096, 4096), activation="relu",
                       compute_dtype=bf16)
    sizes, L = spec.layer_sizes, spec.num_layers
    p = {}
    for j in range(1, L + 1):
        p[f"W{j}"] = torch.randn(sizes[j - 1], sizes[j], generator=gen,
                                 device="cuda").to(bf16)
        p[f"b{j}"] = 0.1 * torch.randn(sizes[j], generator=gen,
                                       device="cuda")
    x = torch.rand(8192, sizes[0], generator=gen, device="cuda").to(bf16)
    logits, hiddens = fused._mlp_forward_cuda(spec, p, x)
    plain_logits, _ = mlp.apply_with_hiddens(spec, p, x)
    for name, fn in ROUTES.items():
        h, plain_h = x, []
        for j in range(1, L + 1):
            acc = fn(h, p[f"W{j}"]) + p[f"b{j}"]
            if j < L:
                h = torch.relu(acc).to(bf16)
                plain_h.append(h)
        scale = float(acc.abs().max())
        last = fn(hiddens[-1], p[f"W{L}"]) + p[f"b{L}"]
        row = dict(
            route=name, logits_scale=scale,
            logits_rel_err=float((logits - acc).abs().max()) / scale,
            hidden_flips=[int((hk != hp).sum())
                          for hk, hp in zip(hiddens, plain_h)],
            hiddens_per_layer=8192 * 4096,
            logits_layer_rel_err=float((logits - last).abs().max()) / scale,
            is_dot_f32_route=bool(torch.equal(acc, plain_logits)))
        print(f"[b1] wide forward, kernel vs plain chain [{name}]: logits "
              f"{row['logits_rel_err']:.3e} of scale {scale:.6g}; hiddens "
              f"rounding elsewhere {row['hidden_flips']} of "
              f"{row['hiddens_per_layer']} per layer; logits layer alone "
              f"{row['logits_layer_rel_err']:.3e}; the route of "
              f"models.mlp.dot_f32: {row['is_dot_f32_route']}", flush=True)
        report["b1_wide"].append(row)
    report["device"] = torch.cuda.get_device_name(0)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
