"""Smoke run of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py

Phases (any failure exits nonzero; none is caught and skipped):

1. build the CUDA kernels from ``distributed_tensorflow_example_tpu_
   torch/ops/csrc`` with nvcc for sm_90a, and print the build time and
   the compiler's register/spill report;
2. hold each kernel (fused LayerNorm, LayerNorm+residual, grouped FFN)
   against its plain PyTorch version on the card at the serving path's
   shapes, with the tolerance stated below, and time the kernel, the
   plain version and a PyTorch library yardstick beside the card's
   bound (bytes / 3.35 TB/s or operations / peak rate);
3. serve at full width — the decode bench model (d_model 1024, 8
   heads, 4 blocks, d_ff 4096, seq_len 1024, vocab 256, bf16 compute,
   f32 params, fused_ln + fp8_ffn) through ``DecodeEngine`` on the card:
   8 ragged greedy requests (prompts 32-300 tokens, 32 new tokens each),
   launch counters zeroed just before and read just after (each
   kernel must have launched), outputs checked, and the first
   request's prefill logits held against the port's CPU path on the
   same params;
4. start the CLI's HTTP server in process on an ephemeral port and
   complete one ``POST /generate``;

and for the MLP trainer (``main.py`` -> ``train/loop.run``):

2b. hold the MLP forward kernel (``mlp_forward``) against its plain
    version at the trainer's two shapes — the reference MLP (100 rows,
    784-100-10, sigmoid, f32) and the wide one (8192 rows,
    784-4096-4096-10, relu, bf16) — logits and hiddens, and the logits
    layer alone on the kernel's last hidden — and time it beside its
    plain version, a cuBLAS ``addmm`` chain and its bound;
5. train at full width: the JAX repo's ``mxu_wide_pallas`` bench
   configuration (784-4096-4096-10, relu, bf16 compute over f32
   params, global batch 8192, ``--pallas``, SGD) for one epoch of 8
   steps on synthetic MNIST, launch counters zeroed just before and
   read just after (``mlp_forward`` must have launched), every printed
   cost finite; print the median step time and examples/s; then one
   step from the same initial state on the card and on the port's CPU
   path, the updated params held against each other;
6. the reference command line on the card: ``main.py --pallas
   --training_epochs=1`` (784-100-10 sigmoid f32, batch 100, 550
   steps), its stdout held to the reference's format and its event
   file read back.

The last two lines of stdout are the kernel report JSON and the
result JSON; the card's name and power limit come just before them.
The script imports nothing of JAX; it needs one card and exits
nonzero without one.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.request

import numpy as np
import torch

# published H100 SXM peaks (NVIDIA data sheet; dense rates)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
L2_BYTES = 50 * 2**20

# tolerances, kernel vs plain version on the same inputs on the card:
# LayerNorm y (f32, values O(1)): the two sum in different orders and
# rsqrtf is within 2 ulp, so agreement is ~1e-6; 1e-4 absolute leaves
# room without hiding a wrong row.  s (the residual sum) is one f32 add
# on both sides and must match bitwise.
LN_ATOL = 1e-4
# grouped FFN (f32 out, values O(1)): f32 accumulation order, and the
# bf16 rounding of the hidden can land one ulp apart (2^-8 relative)
# where the two f32 pre-activations straddle a rounding boundary;
# 1e-3 absolute covers a few such flips per output.
FFN_ATOL = 1e-3
# full-width prefill logits (f32, std ~1), card vs the port's CPU path:
# bf16 attention products and fp8-rounded FFN operands round on both
# sides, and an input that lands on the other side of an e4m3 rounding
# boundary moves one operand by up to 6%; 0.1 absolute is ~25 bf16 ulps
# at magnitude 1.
LOGITS_ATOL = 0.1
# MLP forward, kernel vs plain version, (logits, hiddens) each relative
# to max(1, the output's largest magnitude).  f32 (the reference
# shape): each pre-activation sums 784 products in another order,
# ~1e-5 absolute at these magnitudes, which the activation passes on
# with slope up to 1: 1e-4.  bf16 (the wide shape): the plain version's
# products run on the tensor cores, whose f32 sums take another order
# than the kernel's; a hidden whose two pre-activations straddle a bf16
# rounding boundary lands one bf16 ulp (2^-8 of its magnitude) apart, so
# hiddens within 2^-7 of their scale.  0.65% of the second layer's
# hiddens flip so (scripts/torch_mlp_rounding.py), and the logits sum
# 4096 of them: 1.1e-3 to 1.3e-3 of their scale on the H100, so the
# logits are held to 1e-2, the bound the CPU tests hold bf16 to against
# JAX.  A wrong tile or a missed K slice is off by O(1) relative.
MLP_RTOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 2 ** -7)}
# the logits layer against the plain layer on the kernel's own last
# hidden (no flip carries over from an earlier layer): only the order
# of the f32 sums differs, ~2e-6 of their scale on the H100 at the wide
# shape, held to 1e-5
MLP_LAYER_RTOL = 1e-5
# one full-width SGD step, card vs the port's CPU path: the update
# (new - old params) per leaf, relative to its largest magnitude.  Both
# round the same operands to bf16; the f32 sums run in other orders, so
# a few bf16 roundings of hiddens and of the backward's operands land
# one ulp (2^-8) apart and carry into the gradient sums: 2e-2 of the
# update's scale, where a wrong gradient is off by O(1).
STEP_RTOL = 2e-2

STEP_RE = re.compile(
    r"^Step: \d+,  Epoch: [ \d]\d,  Batch: [ \d]{3} of [ \d]{3},"
    r"  Cost: \d+\.\d{4},  AvgTime: +\d+\.\d{2}ms$")
# the serving path's kernels (phase 3) and the trainer's (phases 5, 6)
SERVE_WRAPPERS = ("fused_layer_norm", "fused_layer_norm_residual",
                  "moe_grouped_matmul")
TRAIN_WRAPPERS = ("mlp_forward",)
# the JAX repo's mxu_wide_pallas bench row, one epoch of 8 steps
WIDE_TRAIN = dict(hidden_sizes=(4096, 4096), activation="relu",
                  compute_dtype="bfloat16", batch_size=8192, pallas=True,
                  dataset="synthetic", synthetic_train_size=8 * 8192,
                  synthetic_test_size=10000, training_epochs=1,
                  summaries=False, frequency=1, seed=1)

FULL_WIDTH = dict(input_size=1024, seq_len=1024, vocab_size=256,
                  d_model=1024, n_heads=8, num_blocks=4, d_ff=4096,
                  activation="gelu", objective="lm", causal=True,
                  fused_ln=True, fp8_ffn=True)
FULL_WIDTH_FLAGS = [
    "--model=transformer", "--objective=lm", "--input_size=1024",
    "--vocab_size=256", "--d_model=1024", "--n_heads=8", "--num_blocks=4",
    "--d_ff=4096", "--activation=gelu", "--compute_dtype=bfloat16",
    "--fused_ln", "--fp8_ffn", "--decode_max_batch=8",
    "--decode_page_size=16", "--seed=0"]


def log(msg: str) -> None:
    print(msg, flush=True)


def device_ms(fn, arg_sets, reps: int = 3) -> float:
    """Device time of one ``fn(*args)`` call in ms: the calls are
    captured into a CUDA graph, cycling over ``arg_sets`` (sized to
    exceed the L2 cache, so every call reads cold inputs as the serving
    path does), and the graph's replays are timed with CUDA events —
    host launch overhead is not in the number."""
    n = max(20, len(arg_sets))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for args in arg_sets[:3]:
            fn(*args)                         # warm-up outside capture
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * n)


def copies(make, bytes_per_set: int):
    """Enough independent input sets to exceed twice the L2 cache."""
    k = min(64, max(1, math.ceil(2 * L2_BYTES / max(1, bytes_per_set))))
    return [make(i) for i in range(k)]


def phase_build():
    from distributed_tensorflow_example_tpu_torch.ops import _build

    t0 = time.monotonic()
    _build.build(verbose=True)
    _build.load()
    secs = time.monotonic() - t0
    log(f"[build] kernels built and loaded in {secs:.2f} s "
        f"({_build.last_build.get('path', 'cached')})")
    for line in (_build.last_build.get("log") or "").splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"[build]   {line.strip()}")


def _gen(seed: int):
    return torch.Generator(device="cuda").manual_seed(seed)


def check_layer_norm(card: str) -> list:
    from distributed_tensorflow_example_tpu_torch.ops import fused

    d = 1024
    out = []
    for residual in (False, True):
        name = "layer_norm_residual" if residual else "layer_norm"
        rows_list = []
        for rows in (8, 512):
            def make(i, rows=rows):
                g = _gen(100 * rows + i)
                x = torch.randn(rows, d, generator=g, device="cuda")
                r = torch.randn(rows, d, generator=g, device="cuda")
                gam = 1 + 0.1 * torch.randn(d, generator=g, device="cuda")
                bet = 0.1 * torch.randn(d, generator=g, device="cuda")
                return (x, r, gam, bet) if residual else (x, gam, bet)

            n_io = 4 if residual else 2       # row tensors read + written
            nbytes = n_io * rows * d * 4 + 2 * d * 4
            sets = copies(make, nbytes)
            if residual:
                y, s = fused.fused_layer_norm_residual(*sets[0])
                y_ref, s_ref = fused.layer_norm_residual_reference(*sets[0])
                if not torch.equal(s, s_ref):
                    raise AssertionError(f"{name}: s differs from x + r")
                kern, plain = (fused.fused_layer_norm_residual,
                               fused.layer_norm_residual_reference)
                lib = None                    # no one-call equivalent
            else:
                y = fused.fused_layer_norm(*sets[0])
                y_ref = fused.layer_norm_reference(*sets[0])
                kern, plain = (fused.fused_layer_norm,
                               fused.layer_norm_reference)

                def lib(x, gam, bet):
                    return torch.nn.functional.layer_norm(
                        x, (d,), gam, bet, eps=fused.LN_EPS)
            torch.cuda.synchronize()
            err = float((y - y_ref).abs().max())
            if not err <= LN_ATOL:
                raise AssertionError(f"{name} rows={rows}: max |kernel - "
                                     f"plain| {err} > {LN_ATOL}")
            flops = rows * d * (10 if residual else 9)
            bound = max(nbytes / HBM_BYTES_PER_S,
                        flops / PEAK_FLOPS[torch.float32]) * 1e3
            row = dict(rows=rows, d=d, max_abs_err=err,
                       ms=device_ms(kern, sets),
                       plain_ms=device_ms(plain, sets),
                       library_ms=(device_ms(lib, sets) if lib else None),
                       bound_ms=bound, bound_by="bytes", bytes=nbytes)
            log(f"[kernel] {name} rows={rows} d={d} f32: max_abs_err="
                f"{err:.3g} (tol {LN_ATOL}) kernel {row['ms']:.5f} ms, "
                f"plain {row['plain_ms']:.5f} ms, library "
                f"{row['library_ms']} ms, bound {bound:.5f} ms (bytes) "
                f"on {card}")
            rows_list.append(row)
        out.append((name, rows_list))
    return out


def check_grouped_ffn(card: str) -> list:
    from distributed_tensorflow_example_tpu_torch.models.mlp import (
        _ACTIVATIONS)
    from distributed_tensorflow_example_tpu_torch.ops import fused
    from distributed_tensorflow_example_tpu_torch.ops.quant import fp8_round

    d, ff, cdt = 1024, 4096, torch.bfloat16
    gelu = _ACTIVATIONS["gelu"]
    rows_list = []
    for c in (8, 512):
        def make(i, c=c):
            g = _gen(7000 + 100 * c + i)
            x = torch.randn(1, c, d, generator=g, device="cuda")
            w1 = torch.randn(1, d, ff, generator=g, device="cuda") / 32
            w2 = torch.randn(1, ff, d, generator=g, device="cuda") / 64
            b1 = 0.1 * torch.randn(1, ff, generator=g, device="cuda")
            b2 = 0.1 * torch.randn(1, d, generator=g, device="cuda")
            # the path's operands: fp8-rounded, then cast to bf16
            return ("gelu", cdt,
                    fp8_round(x, axis=(1, 2)).to(cdt), fp8_round(
                        w1, axis=(1, 2)).to(cdt), b1,
                    fp8_round(w2, axis=(1, 2)).to(cdt), b2)

        nbytes = (c * d * 2 + 2 * d * ff * 2 + ff * 4 + d * 4
                  + c * d * 4)
        sets = copies(make, nbytes)
        out = fused.moe_grouped_matmul(*sets[0])
        ref = fused.grouped_ffn_reference(*sets[0])
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        if not err <= FFN_ATOL:
            raise AssertionError(f"grouped_ffn C={c}: max |kernel - "
                                 f"plain| {err} > {FFN_ATOL}")

        def lib(act, cdt_, x, w1, b1, w2, b2):
            # cuBLAS bf16 products with the bias folded in (bf16 out):
            # a yardstick of speed, not of the same rounding
            h = gelu(torch.baddbmm(b1[:, None].to(cdt_), x, w1))
            return torch.baddbmm(b2[:, None].to(cdt_), h, w2)

        flops = 4 * c * d * ff
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = flops / PEAK_FLOPS[cdt]
        row = dict(rows=c, d=d, ff=ff, max_abs_err=err,
                   ms=device_ms(fused.moe_grouped_matmul, sets),
                   plain_ms=device_ms(fused.grouped_ffn_reference, sets),
                   library_ms=device_ms(lib, sets),
                   bound_ms=max(t_bytes, t_ops) * 1e3,
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   bytes=nbytes, flops=flops)
        log(f"[kernel] grouped_ffn C={c} d={d} ff={ff} bf16: max_abs_err="
            f"{err:.3g} (tol {FFN_ATOL}) kernel {row['ms']:.5f} ms, plain "
            f"{row['plain_ms']:.5f} ms, library {row['library_ms']:.5f} "
            f"ms, bound {row['bound_ms']:.5f} ms ({row['bound_by']}) on "
            f"{card}")
        rows_list.append(row)
    return [("grouped_ffn", rows_list)]


def check_mlp_forward(card: str) -> list:
    """B1 at the trainer's two shapes, the main path's (the wide one)
    first."""
    from distributed_tensorflow_example_tpu_torch.models import mlp
    from distributed_tensorflow_example_tpu_torch.ops import fused

    shapes = [(8192, (4096, 4096), "relu", torch.bfloat16),
              (100, (100,), "sigmoid", torch.float32)]
    rows_list = []
    for n, hidden, act_name, cdt in shapes:
        spec = mlp.MLPSpec(hidden_sizes=hidden, activation=act_name,
                           compute_dtype=cdt)
        sizes = spec.layer_sizes
        L = spec.num_layers

        def make(i, spec=spec, n=n, cdt=cdt):
            # the kernel's operands as the training step hands them over:
            # x and W rounded to the compute dtype, f32 biases
            g = _gen(9000 + n + i)
            p = {}
            for j in range(1, L + 1):
                p[f"W{j}"] = torch.randn(sizes[j - 1], sizes[j], generator=g,
                                         device="cuda").to(cdt)
                p[f"b{j}"] = 0.1 * torch.randn(sizes[j], generator=g,
                                               device="cuda")
            x = torch.rand(n, sizes[0], generator=g, device="cuda").to(cdt)
            return (spec, p, x)

        esz = torch.tensor([], dtype=cdt).element_size()
        weights = sum(sizes[j - 1] * sizes[j] for j in range(1, L + 1))
        nbytes = (n * sizes[0] * esz + weights * esz
                  + sum(sizes[1:]) * 4
                  + sum(n * s_ * esz for s_ in sizes[1:-1])
                  + n * sizes[-1] * 4)
        flops = 2 * n * weights
        sets = copies(make, nbytes)
        # the logits through the wrapper the trainer calls; the hiddens
        # (which the wrapper keeps for its backward) from the launches
        # beneath it
        with torch.no_grad():
            logits = fused.mlp_forward(*sets[0])
        _, hiddens = fused._mlp_forward_cuda(*sets[0])
        ref_logits, ref_hiddens = fused.mlp_forward_reference(*sets[0])
        torch.cuda.synchronize()
        rtol_logits, rtol_hidden = MLP_RTOL[cdt]
        scale = max(1.0, float(ref_logits.abs().max()))
        err = float((logits - ref_logits).abs().max())
        if not err <= rtol_logits * scale:
            raise AssertionError(f"mlp_forward N={n} {sizes}: logits max "
                                 f"|kernel - plain| {err} > {rtol_logits} "
                                 f"x {scale}")
        for j, (h, hr) in enumerate(zip(hiddens, ref_hiddens), start=1):
            hs = max(1.0, float(hr.float().abs().max()))
            he = float((h.float() - hr.float()).abs().max())
            if not he <= rtol_hidden * hs:
                raise AssertionError(f"mlp_forward N={n}: hidden {j} max "
                                     f"|kernel - plain| {he} > "
                                     f"{rtol_hidden} x {hs}")
        # the logits layer alone, on the kernel's last hidden
        last = mlp.dot_f32(hiddens[-1], sets[0][1][f"W{L}"], cdt) \
            + sets[0][1][f"b{L}"]
        layer_err = float((logits - last).abs().max())
        if not layer_err <= MLP_LAYER_RTOL * scale:
            raise AssertionError(f"mlp_forward N={n}: logits layer max "
                                 f"|kernel - plain| {layer_err} > "
                                 f"{MLP_LAYER_RTOL} x {scale}")

        def lib(spec_, p, x):
            # cuBLAS in the compute dtype with the bias folded in, then
            # the activation: a yardstick of speed, not of the rounding
            act = mlp._ACTIVATIONS[spec_.activation]
            h = x
            for j in range(1, spec_.num_layers + 1):
                h = torch.addmm(p[f"b{j}"].to(h.dtype), h, p[f"W{j}"])
                if j < spec_.num_layers:
                    h = act(h)
            return h

        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = flops / PEAK_FLOPS[cdt]
        with torch.no_grad():
            row = dict(rows=n, sizes=list(sizes), dtype=str(cdt),
                       max_abs_err=err, rel_err=err / scale,
                       logits_layer_rel_err=layer_err / scale,
                       ms=device_ms(fused.mlp_forward, sets),
                       plain_ms=device_ms(fused.mlp_forward_reference,
                                          sets),
                       library_ms=device_ms(lib, sets),
                       bound_ms=max(t_bytes, t_ops) * 1e3,
                       bound_by=("bytes" if t_bytes >= t_ops
                                 else "operations"),
                       bytes=nbytes, flops=flops)
        log(f"[kernel] mlp_forward N={n} {'-'.join(map(str, sizes))} "
            f"{act_name} {str(cdt).split('.')[-1]}: max_abs_err={err:.4g} "
            f"(scale {scale:.4g}, tol {rtol_logits} x scale); logits "
            f"layer alone {layer_err / scale:.3g} of scale (tol "
            f"{MLP_LAYER_RTOL}); kernel "
            f"{row['ms']:.5f} ms, plain {row['plain_ms']:.5f} ms, library "
            f"{row['library_ms']:.5f} ms, bound {row['bound_ms']:.5f} ms "
            f"({row['bound_by']}) on {card}")
        rows_list.append(row)
    return [("mlp_forward", rows_list)]


def phase_serve(card: str, device: str = "cuda",
                width: dict = FULL_WIDTH) -> dict:
    from distributed_tensorflow_example_tpu_torch.models import (
        transformer as tfm)
    from distributed_tensorflow_example_tpu_torch.ops import fused
    from distributed_tensorflow_example_tpu_torch.serving import (
        kv_cache as kvc)
    from distributed_tensorflow_example_tpu_torch.serving import (
        scheduler as sched_lib)
    from distributed_tensorflow_example_tpu_torch.serving.engine import (
        DecodeEngine)

    spec = tfm.TransformerSpec(**width, compute_dtype=torch.bfloat16)
    params = tfm.init(spec, seed=0, device=device)
    eng = DecodeEngine(spec, params, page_size=16, max_batch=8,
                       device=device)
    rng = np.random.RandomState(0)
    lo, hi = 32 * spec.seq_len // 1024, 300 * spec.seq_len // 1024
    lens = [int(n) for n in rng.randint(lo, hi + 1, size=8)]
    n_new = 32 * spec.seq_len // 1024
    prompts = [rng.randint(0, spec.vocab_size, size=n).tolist()
               for n in lens]
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    fused.reset_launch_counts()
    t0 = time.monotonic()
    rids = [eng.submit(p, n_new) for p in prompts]
    tick_s = []
    while True:
        ts = time.monotonic()
        if not eng.step():
            break
        tick_s.append(time.monotonic() - ts)
    sync()
    wall = time.monotonic() - t0
    counts = fused.launch_counts()
    for name in SERVE_WRAPPERS:
        if counts[name] <= 0 and device == "cuda":
            raise AssertionError(f"{name} never launched on the main path")
    results = [eng.result(r, timeout=0) for r in rids]
    for res in results:
        if res is None or res["status"] != "result" \
                or len(res["tokens"]) != n_new \
                or not all(0 <= t < spec.vocab_size for t in res["tokens"]):
            raise AssertionError(f"bad serving result: {res}")
    st = eng.stats()
    toks = sum(len(r["tokens"]) for r in results)
    # tick 0 runs the 8 prefills (+ one decode); the rest decode only
    decode_ms = float(np.median(tick_s[1:])) * 1e3
    log(f"[serve] {len(rids)} requests (prompts {min(lens)}-{max(lens)}, "
        f"{n_new} new tokens, greedy) in {wall:.3f} s on {card}: "
        f"{toks / wall:.1f} tokens/s, TTFT p50 {st['ttft_p50_ms']:.2f} ms,"
        f" decode {decode_ms:.3f} ms/tick (median of {len(tick_s) - 1}), "
        f"prefill tick {tick_s[0] * 1e3:.2f} ms; launches {counts}")

    # the first request's prefill logits: card (kernels) vs the port's
    # CPU path (plain versions), same params, same padded batch
    p = prompts[0]
    pb = sched_lib.bucket_for(len(p), eng.prompt_buckets)
    wp = math.ceil(pb / 16)
    toks_np = np.zeros((1, pb), np.int64)
    toks_np[0, :len(p)] = p
    bt = torch.arange(1, wp + 1)[None]

    def prefill(dev, prm):
        cache = kvc.init_paged_cache(spec, wp + 1, 16, device=dev)
        logits, _ = kvc.prefill_into_pages(
            spec, prm, cache, bt.to(dev), torch.from_numpy(toks_np).to(dev),
            torch.tensor([len(p)], device=dev))
        return logits.float().cpu()

    on_card = prefill(device, eng.params)
    on_cpu = prefill("cpu", {k: v.cpu() for k, v in eng.params.items()})
    if not (torch.isfinite(on_card).all() and on_card.shape
            == (1, spec.vocab_size)):
        raise AssertionError("prefill logits not finite / wrong shape")
    err = float((on_card - on_cpu).abs().max())
    same_argmax = int(on_card.argmax()) == int(on_cpu.argmax())
    log(f"[serve] prefill logits (prompt {len(p)}, bucket {pb}) card vs "
        f"CPU path: max_abs_err={err:.4g} (tol {LOGITS_ATOL}), argmax "
        f"equal: {same_argmax}")
    if not err <= LOGITS_ATOL:
        raise AssertionError(f"prefill logits differ from the CPU path by "
                             f"{err} > {LOGITS_ATOL}")
    del eng
    return counts


def phase_http(flags=FULL_WIDTH_FLAGS) -> None:
    from distributed_tensorflow_example_tpu_torch import config
    from distributed_tensorflow_example_tpu_torch.serving import cli

    cfg = config.parse_config(flags + ["--serve_port=0"])
    server, engine = cli.serve(cfg, 0)
    try:
        body = json.dumps({"prompt": list(range(1, 17)),
                           "max_new_tokens": 8}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/generate", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as resp:
            code = resp.status
            doc = json.loads(resp.read())
    finally:
        server.close()
        engine.stop()
    if code != 200 or doc.get("status") != "result" \
            or len(doc.get("tokens", [])) != 8:
        raise AssertionError(f"POST /generate answered {code}: {doc}")
    log(f"[http] POST /generate -> 200, {len(doc['tokens'])} tokens, "
        f"ttft {doc['ttft_ms']} ms, latency {doc['latency_ms']} ms")


def _run_captured(fn, *args):
    """``fn(*args)`` with its stdout captured, then echoed line by line;
    returns ``(result, stdout)``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn(*args)
    out = buf.getvalue()
    for line in out.splitlines():
        log(f"  | {line}")
    return res, out


def _train_counts(phase: str) -> dict:
    from distributed_tensorflow_example_tpu_torch.ops import fused

    torch.cuda.synchronize()
    counts = fused.launch_counts()
    for name in TRAIN_WRAPPERS:
        if counts[name] <= 0:
            raise AssertionError(f"{phase}: {name} never launched on the "
                                 f"main path")
    return counts


def phase_train(card: str) -> dict:
    """The trainer at full width (WIDE_TRAIN) on the card, then one step
    from one initial state on the card and on the CPU."""
    from distributed_tensorflow_example_tpu_torch.config import Config
    from distributed_tensorflow_example_tpu_torch.data import mnist
    from distributed_tensorflow_example_tpu_torch.ops import fused
    from distributed_tensorflow_example_tpu_torch.parallel import step
    from distributed_tensorflow_example_tpu_torch.train import loop, optim
    from distributed_tensorflow_example_tpu_torch.train.state import (
        TrainState, create_train_state)

    cfg = Config(**WIDE_TRAIN, device="cuda")
    torch.cuda.synchronize()
    fused.reset_launch_counts()
    res, out = _run_captured(loop.run, cfg)
    counts = _train_counts("train")
    costs = re.findall(r"Cost: ([^,\s]+)", out)
    if len(costs) != res["steps"] + 1 or not all(
            math.isfinite(float(c)) for c in costs):
        raise AssertionError(f"train: printed costs {costs}")
    if not re.search(r"^Test-Accuracy: \d+\.\d{2}$", out, flags=re.M):
        raise AssertionError("train: no Test-Accuracy line")
    step_ms = [float(m) for m in re.findall(r"AvgTime: +(\d+\.\d+)ms",
                                            out)]
    med = statistics.median(step_ms)
    log(f"[train] {res['steps']} steps of global batch "
        f"{res['global_batch']} ({cfg.hidden_sizes} {cfg.activation} "
        f"{cfg.compute_dtype}, --pallas) on {card}: median step {med:.2f} ms ({cfg.batch_size / med * 1e3:.1f} "
        f"examples/s), steps {step_ms} ms; whole run incl. eval "
        f"{res['total_time_s']:.3f} s; launches {counts}")

    spec = loop.make_spec(cfg)
    opt = optim.make_optimizer(cfg, res["steps"])
    body = step.make_sync_step_body(cfg, spec, opt)
    on_card = create_train_state(spec, opt, seed=cfg.seed, device="cuda")
    cpu_params = {k: v.cpu() for k, v in on_card.params.items()}
    on_cpu = TrainState(on_card.step.cpu(), cpu_params,
                        opt.init(cpu_params))
    batch = mnist.synthesize_split(cfg.batch_size, seed=cfg.seed)
    x, y = torch.from_numpy(batch.images), torch.from_numpy(batch.labels)
    new_card, cost_card, _ = body(on_card, x.cuda(), y.cuda())
    t0 = time.monotonic()
    new_cpu, cost_cpu, _ = body(on_cpu, x, y)
    cpu_s = time.monotonic() - t0
    worst = 0.0
    for k, old in cpu_params.items():
        d_card = new_card.params[k].cpu() - old
        d_cpu = new_cpu.params[k] - old
        scale = float(d_cpu.abs().max())
        rel = float((d_card - d_cpu).abs().max()) / max(scale, 1e-30)
        worst = max(worst, rel)
        if not rel <= STEP_RTOL:
            raise AssertionError(f"train: one step, {k} update card vs CPU "
                                 f"differs by {rel} of its scale {scale} "
                                 f"> {STEP_RTOL}")
    log(f"[train] one step card vs CPU path: cost {float(cost_card):.6g} "
        f"vs {float(cost_cpu):.6g}, worst update difference {worst:.3g} of "
        f"its scale (tol {STEP_RTOL}); CPU step {cpu_s:.1f} s")
    return dict(counts=counts, step_ms_median=med, step_ms=step_ms,
                examples_per_s=cfg.batch_size / med * 1e3)


def phase_cli(card: str) -> dict:
    """The reference command line (its defaults plus --pallas, one
    epoch) on the card: stdout in the reference's format, the event
    file read back."""
    from distributed_tensorflow_example_tpu_torch import main as cli
    from distributed_tensorflow_example_tpu_torch.ops import fused
    from distributed_tensorflow_example_tpu_torch.utils.summary import (
        read_event_file)

    with tempfile.TemporaryDirectory() as logs:
        torch.cuda.synchronize()
        fused.reset_launch_counts()
        rc, out = _run_captured(cli.main, ["--pallas", "--training_epochs=1",
                                           f"--logs_path={logs}"])
        counts = _train_counts("cli")
        files = [f for f in os.listdir(logs) if f.startswith("events.")]
        if rc != 0 or len(files) != 1:
            raise AssertionError(f"cli: exit {rc}, event files {files}")
        events = read_event_file(os.path.join(logs, files[0]))
    lines = out.strip().split("\n")
    steps = [ln for ln in lines if ln.startswith("Step:")]
    if not (lines[0] == "Variables initialized ..." and len(steps) == 6
            and all(STEP_RE.match(ln) for ln in steps)
            and re.match(r"^Test-Accuracy: \d+\.\d{2}$", lines[-4])
            and re.match(r"^Total Time: \d+\.\d{2}s$", lines[-3])
            and re.match(r"^Final Cost: \d+\.\d{4}$", lines[-2])
            and lines[-1] == "done"):
        raise AssertionError("cli: stdout is not the reference's format")
    scalars = [e for e in events if e["scalars"]]
    if len(scalars) != 550 or any(set(e["scalars"]) != {"cost", "accuracy"}
                                  for e in scalars) \
            or sum(1 for e in events if e["graph_nodes"]) != 1:
        raise AssertionError(f"cli: event file holds {len(scalars)} "
                             f"scalar events")
    log(f"[cli] reference format, 550 steps, {len(events)} events read back "
        f"on {card}; launches {counts}")
    return dict(counts=counts)


KERNEL_META = {
    "layer_norm": dict(
        wrapper="fused_layer_norm",
        source="distributed_tensorflow_example_tpu_torch/ops/csrc/"
               "layer_norm.cu",
        replaces="distributed_tensorflow_example_tpu/ops/pallas_fused.py:"
                 "286"),
    "layer_norm_residual": dict(
        wrapper="fused_layer_norm_residual",
        source="distributed_tensorflow_example_tpu_torch/ops/csrc/"
               "layer_norm.cu",
        replaces="distributed_tensorflow_example_tpu/ops/pallas_fused.py:"
                 "292"),
    "grouped_ffn": dict(
        wrapper="moe_grouped_matmul",
        source="distributed_tensorflow_example_tpu_torch/ops/csrc/"
               "grouped_ffn.cu",
        replaces="distributed_tensorflow_example_tpu/ops/pallas_fused.py:"
                 "518"),
    "mlp_forward": dict(
        wrapper="mlp_forward",
        source="distributed_tensorflow_example_tpu_torch/ops/csrc/"
               "mlp_forward.cu",
        replaces="distributed_tensorflow_example_tpu/ops/pallas_fused.py:"
                 "71"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs on the card", file=sys.stderr)
        return 1
    card = torch.cuda.get_device_name(0)
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} on {card}")
    t0 = time.monotonic()
    phase_build()
    measured = (check_layer_norm(card) + check_grouped_ffn(card)
                + check_mlp_forward(card))
    counts = phase_serve(card)
    phase_http()
    train = phase_train(card)
    phase_cli(card)
    # each kernel's launches on its own main path: the full-width serve
    # (phase 3) for the serving kernels, the full-width training run
    # (phase 5) for the MLP forward
    counts.update({k: train["counts"][k] for k in TRAIN_WRAPPERS})
    kernels = []
    for name, rows in measured:
        meta = KERNEL_META[name]
        head = rows[0]          # the main path's shape (decode; wide MLP)
        kernels.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"],
            "launches": counts[meta["wrapper"]],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "shapes": rows,
        })
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[done] all phases passed in {time.monotonic() - t0:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
