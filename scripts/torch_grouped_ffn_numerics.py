"""Where B8's difference from its plain version comes from.

    python3 scripts/torch_grouped_ffn_numerics.py [--out FILE]

On the card, at the serve's decode and prefill shapes (E 1, C 8 / 512,
d 1024, ff 4096, gelu, bf16) with ``chip_smoke.py``'s inputs for
``check_grouped_ffn`` (same seeds, fp8-rounded operands), B8's C entry
point is called with its hidden ``h1`` and, in the training form, its
f32 ``z1`` kept, by the plan the wrapper picks.  Against the plain
version (``fused.grouped_ffn_reference``) and an f64 witness (both
products in f64 on the same bf16 operands, the gelu in f64, the hidden
rounded to bf16) it prints:

- ``out_abs``: max |kernel out - plain out| (chip_smoke.py holds it to
  FFN_ATOL, absolute), and each one's max |out - witness|;
- ``h1_flips``: bf16 hiddens that differ between the kernel and the
  plain version, split into those the sum order of z1 explains (the
  plain version's gelu at the kernel's z1 against the plain hidden) and
  those the epilogue's gelu explains (the kernel's hidden against the
  plain gelu at the kernel's z1);
- ``out_from_flips``: max |plain launch 2 on the kernel's hidden -
  plain out|, the part of ``out_abs`` the flips carry; the rest is
  launch 2's own sum order.

The same numbers go to ``--out`` as JSON.  Needs one card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)


def _inputs(c: int, d: int, ff: int):
    """chip_smoke.check_grouped_ffn's first input set at C rows."""
    from distributed_tensorflow_example_tpu_torch.ops.quant import fp8_round

    cdt = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(7000 + 100 * c)
    x = torch.randn(1, c, d, generator=g, device="cuda")
    w1 = torch.randn(1, d, ff, generator=g, device="cuda") / 32
    w2 = torch.randn(1, ff, d, generator=g, device="cuda") / 64
    b1 = 0.1 * torch.randn(1, ff, generator=g, device="cuda")
    b2 = 0.1 * torch.randn(1, d, generator=g, device="cuda")
    return (fp8_round(x, axis=(1, 2)).to(cdt),
            fp8_round(w1, axis=(1, 2)).to(cdt), b1,
            fp8_round(w2, axis=(1, 2)).to(cdt), b2)


def _kernel(fused, x, w1, b1, w2, b2):
    """``(out, h1, z1)`` of the C entry point, training form."""
    e, c, d = x.shape
    ff = w1.shape[-1]
    plan = fused.grouped_ffn_plan(e, c, d, ff, torch.cuda.get_device_properties(
        0).multi_processor_count)
    h1 = torch.empty((e, c, ff), dtype=torch.bfloat16, device="cuda")
    out = torch.empty((e, c, d), dtype=torch.float32, device="cuda")
    z1 = torch.empty((e, c, ff), dtype=torch.float32, device="cuda")
    shares = max(plan[0][1] * ff, plan[1][1] * d)
    part = torch.empty((shares * e * c,), dtype=torch.float32, device="cuda")
    fused._launch("dtx_grouped_ffn_fwd", x.data_ptr(), w1.data_ptr(),
                  b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), h1.data_ptr(),
                  out.data_ptr(), z1.data_ptr(), part.data_ptr(), e, c, d,
                  ff, 0, 1, *plan[0], *plan[1])
    return out, h1, z1, plan


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        _REPO, "build", "torch_grouped_ffn_numerics.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from distributed_tensorflow_example_tpu_torch.models.mlp import (
        _ACTIVATIONS)
    from distributed_tensorflow_example_tpu_torch.ops import fused

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    gelu = _ACTIVATIONS["gelu"]
    f64 = torch.float64
    report = {"card": card, "cases": []}
    d, ff = 1024, 4096
    for c in (8, 512):
        x, w1, b1, w2, b2 = _inputs(c, d, ff)
        out_k, h1_k, z1_k, plan = _kernel(fused, x, w1, b1, w2, b2)
        prim = fused.moe_grouped_matmul("gelu", torch.bfloat16, x, w1, b1,
                                        w2, b2)
        out_p, z1_p = fused.grouped_ffn_reference("gelu", torch.bfloat16,
                                                  x, w1, b1, w2, b2)
        h1_p = gelu(z1_p).to(torch.bfloat16)
        h1_at_kz = gelu(z1_k).to(torch.bfloat16)

        def launch2(h1):
            return torch.bmm(h1.to(torch.float32), w2.to(torch.float32)) \
                + b2[:, None]

        z1_w = torch.bmm(x.to(f64), w1.to(f64)) + b1.to(f64)[:, None]
        h1_w = gelu(z1_w).to(torch.bfloat16)
        out_w = torch.bmm(h1_w.to(f64), w2.to(f64)) + b2.to(f64)[:, None]
        torch.cuda.synchronize()

        def mx(a, b):
            return float((a.to(f64) - b.to(f64)).abs().max())

        case = dict(
            rows=c, plan=plan,
            out_abs=mx(out_k, out_p), primal_out_abs=mx(prim, out_p),
            primal_bitwise_to_training_form=bool(torch.equal(prim, out_k)),
            kernel_vs_witness=mx(out_k, out_w),
            plain_vs_witness=mx(out_p, out_w),
            z1_abs=mx(z1_k, z1_p),
            z1_rel=mx(z1_k, z1_p) / float(z1_p.abs().max()),
            h1_elements=h1_k.numel(),
            h1_flips=int((h1_k != h1_p).sum()),
            h1_flips_from_z1=int((h1_at_kz != h1_p).sum()),
            h1_flips_from_gelu=int((h1_k != h1_at_kz).sum()),
            kernel_h1_flips_vs_witness=int((h1_k != h1_w).sum()),
            plain_h1_flips_vs_witness=int((h1_p != h1_w).sum()),
            out_from_flips=mx(launch2(h1_k), out_p),
            out_from_launch2=mx(out_k, launch2(h1_k)))
        report["cases"].append(case)
        print(f"[b8-numerics] C={c} plan {plan} on {card}: "
              + ", ".join(f"{k}={v:.4g}" if isinstance(v, float)
                          else f"{k}={v}" for k, v in case.items()
                          if k not in ("rows", "plan")), flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
