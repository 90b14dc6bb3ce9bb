"""What feeds B1's tensor-core GEMM, and what each of its layers costs.

    python3 scripts/torch_copy_bench.py [--out FILE]

Two parts, on the card:

1. the copy microbenchmark of ``scripts/torch_copy_bench.cu`` (built here
   with nvcc for sm_90a): one CTA of 256 threads per SM streams 48 KB
   tiles through a ring of four stages two tiles ahead, by 16-byte
   cp.async into the no-swizzle core-matrix tiles of ``ops/csrc/tc.cuh``
   (the flash kernels' feed), by 16-byte loads and shared stores, and by
   TMA boxes into 128-byte swizzled tiles; each from device memory (every
   CTA its own rows) and from L2 (every CTA the same rows): TB/s and
   GB/s per SM;
2. the wide MLP's three bf16 layers (8192 rows, 784-4096-4096-10, relu;
   f32 logits) one launch each through the kernel library's
   ``dtx_mlp_layer_fwd``, against ``torch.addmm`` on the same operands:
   ms, TFLOP/s and the largest difference from an f32 product relative
   to its scale.

Prints one line per measurement with the card's name and power limit and
writes them to ``--out`` as JSON.  Needs one card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
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


def _copy_lib():
    from distributed_tensorflow_example_tpu_torch.ops import _build

    out_dir = os.path.join(_REPO, "build", "copy_bench")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libcopy_bench.so")
    subprocess.run([_build.nvcc(), *_build.ARCH_FLAGS, *_build.NVCC_FLAGS,
                    "-shared", "-o", lib,
                    os.path.join(_REPO, "scripts", "torch_copy_bench.cu")],
                   check=True)
    cdll = ctypes.CDLL(lib)
    P, U, I = ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_int
    cdll.copy_bench.argtypes = [I, P, U, U, I, I, I, P]
    cdll.copy_bench.restype = I
    return cdll


def copies(card: str) -> list:
    lib = _copy_lib()
    ctas = torch.cuda.get_device_properties(0).multi_processor_count
    ld, iters = 4096, 512
    buf = torch.ones(ctas * 384 * ld, dtype=torch.bfloat16, device="cuda")
    sink = torch.zeros(1, device="cuda")
    rows = []
    for mode, how in ((0, "cp.async 16 B, no-swizzle tiles"),
                      (1, "16 B loads + shared stores, no-swizzle tiles"),
                      (2, "TMA boxes, 128-byte swizzle")):
        for shared, source in ((0, "device memory"), (1, "L2")):
            def run():
                rc = lib.copy_bench(mode, buf.data_ptr(), ld, ctas * 384,
                                    ctas, iters, shared, sink.data_ptr())
                if rc:
                    raise RuntimeError(f"copy_bench mode {mode}: error {rc}")
            ms = _ms(run, 5)
            nbytes = ctas * iters * 48 * 1024
            row = dict(part="copy", how=how, source=source, ms=ms,
                       tb_s=nbytes / ms / 1e9,
                       gb_s_per_sm=nbytes / ms / 1e6 / ctas, card=card)
            print(f"[copy] {how} from {source}: {ms:.3f} ms, "
                  f"{row['tb_s']:.2f} TB/s, {row['gb_s_per_sm']:.1f} GB/s "
                  f"per SM on {card}", flush=True)
            rows.append(row)
    return rows


def layers(card: str) -> list:
    from distributed_tensorflow_example_tpu_torch.ops import _build

    lib = _build.load()
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device="cuda").manual_seed(0)
    m = 8192
    rows = []
    for k, n, last in ((784, 4096, 0), (4096, 4096, 0), (4096, 10, 1)):
        a = torch.rand(m, k, generator=g, device="cuda").to(torch.bfloat16)
        w = (torch.randn(k, n, generator=g, device="cuda")
             / k ** 0.5).to(torch.bfloat16)
        b = 0.1 * torch.randn(n, generator=g, device="cuda")
        out = torch.empty(m, n, device="cuda", dtype=(
            torch.float32 if last else torch.bfloat16))

        def kernel():
            rc = lib.dtx_mlp_layer_fwd(a.data_ptr(), w.data_ptr(),
                                       b.data_ptr(), out.data_ptr(), m, n, k,
                                       1, 1, last, 1, stream)
            if rc:
                raise RuntimeError(f"dtx_mlp_layer_fwd: error {rc}")

        kernel()
        z = a.float() @ w.float() + b
        want = z if last else torch.relu(z)
        err = float((out.float() - want).abs().max()) \
            / max(1.0, float(want.abs().max()))
        flops = 2 * m * k * n
        ms = _ms(kernel)
        lib_ms = _ms(lambda: torch.addmm(b.to(torch.bfloat16), a, w))
        row = dict(part="layer", m=m, k=k, n=n, ms=ms,
                   tflops=flops / ms / 1e9, addmm_ms=lib_ms,
                   rel_err_vs_f32=err, card=card)
        print(f"[layer] {m} x {k} -> {n}: kernel {ms:.4f} ms "
              f"({row['tflops']:.1f} TFLOP/s), addmm {lib_ms:.4f} ms, "
              f"{err:.3g} of scale from the f32 product on {card}",
              flush=True)
        rows.append(row)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_copy_bench: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    rows = copies(card) + layers(card)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
