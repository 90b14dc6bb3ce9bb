"""Smoke run of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py

Phases (any failure exits nonzero; none is caught and skipped):

1. build the CUDA kernels from ``distributed_tensorflow_example_tpu_
   torch/ops/csrc`` with nvcc for sm_90a, and print the build time and
   each kernel's registers and spills from the compiler's report;
2. hold each kernel (fused LayerNorm, LayerNorm+residual, grouped FFN)
   against its plain PyTorch version on the card at the serving path's
   shapes (and the two LayerNorm forms at the transformer trainer's
   65,536 x 1024 f32 rows too), with the tolerance stated below, and
   time the kernel, the plain version and a PyTorch library yardstick
   beside the card's bound (bytes / 3.35 TB/s or operations / peak
   rate); the rows carry each kernel's design, registers and spills,
   the factor against the library call and, for the grouped FFN, its
   TFLOP/s and its launch plan (tile width, split of K, CTAs per
   launch);
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
    plain version, a cuBLAS ``addmm`` chain and its bound; the bf16 row
    carries the tensor-core GEMM's registers and spills, TFLOP/s and the
    factor against the ``addmm`` chain;
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
   file read back;

and for the transformer trainer (``main.py --model=transformer`` ->
``train/loop.run``):

2c. hold the flash forward (both forms), flash dq, flash dk/dv and the
    LayerNorm backward against their plain versions on the card — the
    attention kernels compared at [1, 8192, 8, 128] bf16 causal (the
    plain scores of the full batch would take 17 GB) and at two ragged
    shapes, timed at the path's [8, 8192, 8, 128], where each batch
    element of the timed launches' outputs is held against the plain
    version on that element's inputs; the LayerNorm
    backward at 65,536 x 1024 f32 — and time each beside its plain
    version, a PyTorch library call and its bound; the rows of the
    bf16 tensor-core forward, dq and dk/dv also carry their design,
    registers and spilled bytes (from the compiler's report of the
    loaded library's build), TFLOP/s and the factor against the library
    call;
7. train at full width: the JAX repo's ``transformer_wide_long`` bench
   configuration (causal flash attention, --fused_ln, d_model 1024, 8
   heads of 128, 4 blocks, d_ff 4096, S 8192, bf16 compute, Adam with
   bf16 moments, batch 8) for 4 steps on synthetic data with a test set
   of 8, launch counters zeroed just before and read just after (every
   kernel of the path must have launched), every printed cost finite;
   print the median step time, tokens/s, model TFLOP/s and the peak
   memory;
7b. one step of the same model cut to 1 block, S 2048, batch 2, from
    one initial state on the card and on the port's CPU path, the
    updates held against each other.

and for MoE training (``main.py --model=transformer --num_experts=64
--moe_dispatch=alltoall --grouped_moe [--fp8_ffn]`` -> ``train/loop.run``):

2d. hold B8's training form (``moe_grouped_matmul_z1``: out and the f32
    pre-activation z1) against its plain version at the path's
    [64, 640, 1024] x ff 2048 bf16 gelu, at a ragged C and at E = 1 (the
    dense fp8 case), and time it and its primal form beside its plain
    version, a ``baddbmm`` + gelu + ``baddbmm`` yardstick and its bound
    (TFLOP/s, the factor against the yardstick, the plan, registers and
    spills); time the four plain products of its backward there too;
8.  train at full width: the JAX repo's ``moe_wide`` bench row (E 64,
    top-1, capacity factor 1.25 -> C 640, causal flash attention,
    d_model 1024, 8 heads of 128, 2 blocks, d_ff 2048, S 1024, bf16
    compute, Adam with bf16 moments, batch 32) for 4 steps with a test
    set of 8, first under ``--grouped_moe``, then under ``--grouped_moe
    --fp8_ffn``; launch counters zeroed just before and read just after
    each run (B5, B6, B7, B8's training form and, in eval, its primal
    form must have launched), every printed cost finite; print the
    median step time, tokens/s, model TFLOP/s and the peak memory;
8b. one step of the same model cut to 1 block, E 8, S 256, batch 4, top-2,
    ``--moe_aux_weight=0.01`` and capacity factor 1.0 (tokens drop) from
    one initial state on the card and on the port's CPU path: the
    router's choices compared first (the count that differ printed),
    then, with the CPU step held to the card's choices, the updates held
    against each other.

The last two lines of stdout are the kernel report JSON (each kernel's
launches on its first main path, and under ``launches_by_path`` on
every path that ran it) and the result JSON; the card's name and power limit come just before them.
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
# flash attention, kernel vs plain version on the same inputs: bf16 at
# the path's shape, where the forward rounds p to bf16 against the
# running max of each 64-key tile and the plain version against the
# row's final max (one bf16 ulp per element), and o, dq, dk, dv sum
# thousands of such terms: 1e-2 of each output's scale, the bound the
# CPU tests hold bf16 to against JAX; f32 sums in other orders: 1e-4.
# A wrong tile or a missed mask is off by O(1) of scale.
FLASH_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
# LayerNorm backward (f32): dx per row and dg/db summed over 65,536 rows
# in another order: 1e-4 of each output's scale
LN_BWD_RTOL = 1e-4
# one full-width transformer step (1 block, S 2048, batch 2), card vs
# the port's CPU path, SGD so the update is -lr x the gradient: bf16
# products on the tensor cores sum in another order than the CPU's f32
# products of the same bf16 operands, so bf16 roundings of activations,
# of p and of ds land one ulp (2^-8) apart here and there and carry
# into the gradient sums: 2e-2 of each update's scale, where a wrong
# gradient is off by O(1)
TFM_STEP_RTOL = 2e-2

# B8's training form (phase 2d), kernel vs plain version on the same
# inputs at the path's shape, each relative to the output's largest
# magnitude: out as the primal form (a bf16 hidden may round one ulp
# apart where the two f32 pre-activations straddle a boundary; out sums
# 2048 of them: 1e-3 of scale); z1, the f32 sum of the same 1024 exact
# bf16 products in another order: 1e-5 of scale.  A wrong tile, a missed
# K slice or a z1 stored off by a row is off by O(1) of scale.
Z1_OUT_RTOL = 1e-3
Z1_RTOL = 1e-5
# one full-width MoE step (1 block, E 8, S 256, batch 4, top-2), card vs
# the port's CPU path held to the card's routing, SGD: as TFM_STEP_RTOL,
# bf16 roundings of activations, of p, of the expert hidden and of the
# backward's operands land one ulp apart here and there: 2e-2 of each
# update's scale.
MOE_STEP_RTOL = 2e-2
# the share of tokens whose routing may differ card vs CPU before the
# router counts as wrong: a choice flips only where two probabilities
# tie within the bf16 noise of the router's input; a wrong sort, tie
# rule or product moves most of them
MOE_FLIP_LIMIT = 0.01

# the serving path's kernels (phase 3), the MLP trainer's (phases 5, 6)
# and the transformer trainer's (phase 7)
SERVE_WRAPPERS = ("fused_layer_norm", "fused_layer_norm_residual",
                  "moe_grouped_matmul")
TRAIN_WRAPPERS = ("mlp_forward",)
TFM_WRAPPERS = ("fused_layer_norm", "fused_layer_norm_residual",
                "layer_norm_backward", "flash_forward", "flash_dq",
                "flash_dkv")
# the JAX repo's mxu_wide_pallas bench row, one epoch of 8 steps
WIDE_TRAIN = dict(hidden_sizes=(4096, 4096), activation="relu",
                  compute_dtype="bfloat16", batch_size=8192, pallas=True,
                  dataset="synthetic", synthetic_train_size=8 * 8192,
                  synthetic_test_size=10000, training_epochs=1,
                  summaries=False, frequency=1, seed=1)

# the JAX repo's transformer_wide_long bench row (bench.py), 4 steps
WIDE_LONG_FLAGS = [
    "--model=transformer", "--attention=flash", "--causal", "--fused_ln",
    "--input_size=32768", "--seq_len=8192", "--d_model=1024",
    "--n_heads=8", "--num_blocks=4", "--d_ff=4096",
    "--compute_dtype=bfloat16", "--optimizer=adam",
    "--adam_moments_dtype=bfloat16", "--learning_rate=1e-3",
    "--batch_size=8", "--dataset=synthetic", "--synthetic_train_size=32",
    "--synthetic_test_size=8", "--no_summaries", "--frequency=1",
    "--training_epochs=1"]
# phase 7b: the same widths cut to 1 block, S 2048, batch 2, SGD
STEP_CHECK_FLAGS = [
    "--model=transformer", "--attention=flash", "--causal", "--fused_ln",
    "--input_size=8192", "--seq_len=2048", "--d_model=1024", "--n_heads=8",
    "--num_blocks=1", "--d_ff=4096", "--compute_dtype=bfloat16",
    "--optimizer=sgd", "--learning_rate=1e-2", "--batch_size=2"]

# the JAX repo's moe_wide bench row (bench.py), 4 steps; phase 8 runs it
# with --grouped_moe, then with --grouped_moe --fp8_ffn
MOE_WIDE_FLAGS = [
    "--model=transformer", "--num_experts=64", "--moe_dispatch=alltoall",
    "--moe_topk=1", "--capacity_factor=1.25", "--attention=flash",
    "--causal", "--input_size=4096", "--seq_len=1024", "--d_model=1024",
    "--n_heads=8", "--num_blocks=2", "--d_ff=2048",
    "--compute_dtype=bfloat16", "--optimizer=adam",
    "--adam_moments_dtype=bfloat16", "--learning_rate=1e-3",
    "--batch_size=32", "--dataset=synthetic", "--synthetic_train_size=128",
    "--synthetic_test_size=8", "--no_summaries", "--frequency=1",
    "--training_epochs=1"]
MOE_WRAPPERS = ("flash_forward", "flash_dq", "flash_dkv",
                "moe_grouped_matmul_z1", "moe_grouped_matmul")
# phase 8b: the same widths cut to 1 block, E 8, S 256, batch 4, top-2
# with the balance loss and a capacity factor of 1.0 (C 256 for 2048
# units over 8 experts: the fuller experts drop), SGD
MOE_STEP_FLAGS = [
    "--model=transformer", "--num_experts=8", "--moe_dispatch=alltoall",
    "--moe_topk=2", "--capacity_factor=1.0", "--moe_aux_weight=0.01",
    "--grouped_moe", "--attention=flash", "--causal", "--input_size=1024",
    "--seq_len=256", "--d_model=1024", "--n_heads=8", "--num_blocks=1",
    "--d_ff=2048", "--compute_dtype=bfloat16", "--optimizer=sgd",
    "--learning_rate=1e-2", "--batch_size=4"]

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


def event_ms(fn, args, reps: int = 3) -> float:
    """Device time of one ``fn(*args)`` call in ms, for calls long
    enough (milliseconds) that host launch overhead does not count and
    whose temporaries are too large to keep one set per call of a CUDA
    graph: one warm-up call, then ``reps`` calls between CUDA events."""
    fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def copies(make, bytes_per_set: int):
    """Enough independent input sets to exceed twice the L2 cache."""
    k = min(64, max(1, math.ceil(2 * L2_BYTES / max(1, bytes_per_set))))
    return [make(i) for i in range(k)]


def ptxas_usage(text: str) -> dict:
    """{mangled kernel name: {"regs", "spill_stores", "spill_loads"}}
    from the compiler's ``-Xptxas -v`` report."""
    usage: dict = {}
    cur = None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", line)
        if m:
            cur = usage.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur.update(spill_stores=int(m.group(1)),
                       spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["regs"] = int(m.group(1))
    return usage


# the bf16 tensor-core kernels behind B5's two forms, B6 and B7 at the
# path's causal shape and behind B1's bf16 layers (fragments of their
# mangled names), and their registers and spills from the compiler's
# report of the loaded library's build (phase 1)
FLASH_TC = {"stats": "flash_fwd_tc_kernelILb1ELb1EE",
            "normalized": "flash_fwd_tc_kernelILb1ELb0EE",
            "dq": "flash_dq_tc_kernelILb1EE",
            "dkv": "flash_dkv_tc_kernelILb1EE"}
FLASH_USAGE: dict = {}
# each source that includes gemm_tc.cuh compiles its own copy of the
# GEMM (internal linkage), so those fragments name the source too
MLP_TC = {"hidden": ("mlp_forward_cu",
                     "gemm_bias_act_tc_kernelI13__nv_bfloat16Li2ELb0EE"),
          "logits": ("mlp_forward_cu", "gemm_bias_act_tc_kernelIfLi2ELb0EE")}
MLP_USAGE: dict = {}
# B8's bf16 products on that GEMM (bf16 hidden with and without z1, and
# f32 output or split-K shares, at 256- and 128-wide tiles), keyed by
# (OutT, halves, z1), and B2/B3's register path (f32 and bf16 rows)
B8_TC = {(out, halves, z1): ("grouped_ffn_cu",
                             f"gemm_bias_act_tc_kernelI{mangled}Li{halves}"
                             f"ELb{int(z1)}EE")
         for out, mangled in (("bf16", "13__nv_bfloat16"), ("f32", "f"))
         for halves in (1, 2) for z1 in (False, True)
         if out == "bf16" or not z1}
B8_USAGE: dict = {}
# and B2/B3's two routes, keyed by (name, dtype, route): the register
# path (a warp a row) and the CTA-a-row kernel wider rows take
LN_KERNELS = {(name, dt, route): f"{kernel}I{mangled}Lb{int(res)}EE"
              for name, res in (("layer_norm", False),
                                ("layer_norm_residual", True))
              for dt, mangled in (("f32", "f"), ("bf16", "13__nv_bfloat16"))
              for route, kernel in (("warp", "ln_fwd_warp_kernel"),
                                    ("block", "ln_fwd_kernel"))}
LN_USAGE: dict = {}
LN_DESIGN = {"warp": "warp per row, registers, shuffles",
             "block": "CTA per row, shared memory, block reductions"}


def _usage_row(uses) -> dict:
    """The most registers and the sum of spilled bytes over the
    instantiations a call runs."""
    return dict(regs=max(u["regs"] for u in uses),
                spill_bytes=sum(u.get("spill_stores", 0)
                                + u.get("spill_loads", 0) for u in uses))


def phase_build():
    from distributed_tensorflow_example_tpu_torch.ops import _build

    t0 = time.monotonic()
    _build.build()
    _build.load()
    secs = time.monotonic() - t0
    how = ("built and loaded" if _build.last_build.get("seconds") is not None
           else "reused and loaded")
    log(f"[build] kernels {how} in {secs:.2f} s "
        f"({_build.last_build.get('path')})")
    usage = ptxas_usage(_build.last_build.get("log") or "")
    for frags, into in ((FLASH_TC, FLASH_USAGE), (MLP_TC, MLP_USAGE),
                        (B8_TC, B8_USAGE), (LN_KERNELS, LN_USAGE)):
        for form, frag in frags.items():
            parts = (frag,) if isinstance(frag, str) else frag
            found = [u for name, u in usage.items()
                     if all(p in name for p in parts)]
            if len(found) != 1 or "regs" not in found[0]:
                raise RuntimeError(f"the compiler's report names "
                                   f"{len(found)} kernels with registers "
                                   f"matching {parts}")
            use = into[form] = found[0]
            log(f"[build]   {' '.join(parts)}: {use['regs']} registers, "
                f"spill stores "
                f"{use.get('spill_stores', 0)} B, loads "
                f"{use.get('spill_loads', 0)} B")


def _gen(seed: int):
    return torch.Generator(device="cuda").manual_seed(seed)


def _ln_route(d: int, tensors) -> str:
    """The route layer_norm.cu's forward takes for rows ``d`` wide with
    these operands: the register path ("warp") where d is at most
    ``dtx_layer_norm_reg_max_d``, a multiple of the 4-value vector, and
    every operand lies on its vector's boundary (the outputs are fresh
    allocations, which do), else the CTA-a-row kernel ("block")."""
    from distributed_tensorflow_example_tpu_torch.ops import _build

    reg = (d <= _build.load().dtx_layer_norm_reg_max_d() and d % 4 == 0
           and all(t.data_ptr() % (4 * t.element_size()) == 0
                   for t in tensors))
    return "warp" if reg else "block"


def check_layer_norm(card: str) -> list:
    from distributed_tensorflow_example_tpu_torch.ops import fused

    d = 1024
    out = []
    for residual in (False, True):
        name = "layer_norm_residual" if residual else "layer_norm"
        rows_list = []
        # the decode and prefill rows of the serve, then the transformer
        # trainer's 8 x 8192 rows
        for rows in (8, 512, 8 * 8192):
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
            route = _ln_route(d, sets[0])
            row.update(design=LN_DESIGN[route],
                       **_usage_row([LN_USAGE[(name, "f32", route)]]))
            if lib:
                row["x_library"] = row["ms"] / row["library_ms"]
            log(f"[kernel] {name} rows={rows} d={d} f32: max_abs_err="
                f"{err:.3g} (tol {LN_ATOL}) kernel {row['ms']:.5f} ms, "
                f"plain {row['plain_ms']:.5f} ms, library "
                f"{row['library_ms']} ms"
                + (f" (kernel {row['x_library']:.2f}x)" if lib else "")
                + f", bound {bound:.5f} ms (bytes; kernel at "
                f"{bound / row['ms']:.1%}) on {card}; {row['design']}, "
                f"{row['regs']} registers, {row['spill_bytes']} B spilled")
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
        ref = fused.grouped_ffn_reference(*sets[0])[0]
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
        plan = _b8_plan(fused.moe_grouped_matmul.last_plan, 1, c, d, ff)
        row = dict(rows=c, d=d, ff=ff, max_abs_err=err,
                   ms=device_ms(fused.moe_grouped_matmul, sets),
                   plain_ms=device_ms(fused.grouped_ffn_reference, sets),
                   library_ms=device_ms(lib, sets),
                   bound_ms=max(t_bytes, t_ops) * 1e3,
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   bytes=nbytes, flops=flops, **plan)
        row.update(tflops=flops / row["ms"] / 1e9,
                   x_library=row["ms"] / row["library_ms"])
        log(f"[kernel] grouped_ffn C={c} d={d} ff={ff} bf16: max_abs_err="
            f"{err:.3g} (tol {FFN_ATOL}) kernel {row['ms']:.5f} ms "
            f"({row['tflops']:.2f} TFLOP/s), plain {row['plain_ms']:.5f} "
            f"ms, library {row['library_ms']:.5f} ms (kernel "
            f"{row['x_library']:.2f}x), bound {row['bound_ms']:.5f} ms "
            f"({row['bound_by']}; kernel at "
            f"{row['bound_ms'] / row['ms']:.1%}) on {card}; {row['design']}, "
            f"CTAs per launch {row['ctas']}, {row['regs']} registers, "
            f"{row['spill_bytes']} B spilled")
        rows_list.append(row)
    return [("grouped_ffn", rows_list)]


def _b8_plan(plan, e: int, c: int, d: int, ff: int,
             z1: bool = False) -> dict:
    """What the bf16 grouped FFN launched at [E, C, d] x ff under
    ``plan`` (the wrapper's ``last_plan``): its design, the CTAs of each
    launch (a split launch's shares; its sum's launch noted), and the
    registers and spills of the tensor-core instantiations it ran."""
    from distributed_tensorflow_example_tpu_torch.ops import fused

    uses, parts = [], []
    for i, (halves, splits) in enumerate(plan):
        # launch 1 unsplit writes the bf16 hidden (and z1); a split
        # launch writes f32 shares, launch 2 f32 out
        fused_epi = i == 0 and splits == 1
        uses.append(B8_USAGE[("bf16" if fused_epi else "f32", halves,
                              z1 and fused_epi)])
        parts.append(f"launch {i + 1} 128x{128 * halves}"
                     + (f", K in {splits} shares + sum" if splits > 1
                        else ""))
    return dict(design="wgmma+TMA, " + "; ".join(parts), plan=plan,
                ctas=list(fused.grouped_ffn_ctas(plan, e, c, d, ff)),
                **_usage_row(uses))


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
        row.update(tflops=flops / row["ms"] / 1e9,
                   x_library=row["ms"] / row["library_ms"])
        if cdt == torch.bfloat16:
            use = MLP_USAGE["hidden"]
            row.update(design="wgmma+TMA", regs=use["regs"],
                       spill_bytes=(use.get("spill_stores", 0)
                                    + use.get("spill_loads", 0)))
        log(f"[kernel] mlp_forward N={n} {'-'.join(map(str, sizes))} "
            f"{act_name} {str(cdt).split('.')[-1]}: max_abs_err={err:.4g} "
            f"(scale {scale:.4g}, tol {rtol_logits} x scale); logits "
            f"layer alone {layer_err / scale:.3g} of scale (tol "
            f"{MLP_LAYER_RTOL}); kernel "
            f"{row['ms']:.5f} ms ({row['tflops']:.2f} TFLOP/s), plain "
            f"{row['plain_ms']:.5f} ms, library "
            f"{row['library_ms']:.5f} ms (kernel {row['x_library']:.2f}x), "
            f"bound {row['bound_ms']:.5f} ms ({row['bound_by']}) on {card}"
            + (f"; {row['design']}, {row['regs']} registers, "
               f"{row['spill_bytes']} B spilled" if "design" in row
               else ""))
        rows_list.append(row)
    return [("mlp_forward", rows_list)]


def _errs(got, want) -> tuple:
    """(max |got - want|, that over the largest |want|)."""
    err = float((got.float() - want.float()).abs().max())
    return err, err / max(float(want.float().abs().max()), 1e-30)


def _flash_bytes_flops(b, s, h, d, causal, which):
    """(bytes, flops) the card must move and do for one call: each
    input read once and each output written once (bf16 q, k, v, do; f32
    m, l, dlt and f32 outputs), and the products over the (q, key)
    pairs the causal mask leaves: 4d flops per pair for the forward
    (q.k, p.v), 6d for dq (q.k, do.v, ds.k), 8d for dk/dv (q.k, do.v,
    p.do, ds.q)."""
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    elem = b * s * h * d
    rows = b * s * h
    if which == "stats":
        return 3 * elem * 2 + elem * 4 + 2 * rows * 4, 4 * d * pairs
    if which == "normalized":
        return 3 * elem * 2 + elem * 2, 4 * d * pairs
    if which == "dq":
        return 4 * elem * 2 + 3 * rows * 4 + elem * 4, 6 * d * pairs
    return 4 * elem * 2 + 3 * rows * 4 + 2 * elem * 4, 8 * d * pairs


def _bound(nbytes, flops, dtype=torch.bfloat16):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_flash(card: str) -> list:
    """B5 (both forms), B6 and B7 against their plain versions, then
    timed at the path's shape."""
    import torch.nn.functional as F

    from distributed_tensorflow_example_tpu_torch.ops import (
        flash_attention as fa)

    cdt = torch.bfloat16
    tol = FLASH_TOL[cdt]

    def inputs(b, s, h, d, seed):
        g = _gen(seed)
        return [torch.randn(b, s, h, d, generator=g, device="cuda").to(cdt)
                for _ in range(4)]

    # per kernel: (largest absolute error, largest error of scale)
    errs = {"flash_forward": (0.0, 0.0), "flash_dq": (0.0, 0.0),
            "flash_dkv": (0.0, 0.0)}
    # the transformer path's length at batch 1, the MoE path's whole
    # batch (about 1 GB of f32 scores per plain tensor), then two ragged
    # shapes
    for b, s, h, d, causal in ((1, 8192, 8, 128, True),
                               (32, 1024, 8, 128, True),
                               (2, 1000, 8, 128, True),
                               (1, 300, 8, 64, False)):
        q, k, v, do = inputs(b, s, h, d, 11000 + s)
        o_r = fa.flash_attention_reference(q, k, v, causal)
        acc_r, m_r, l_r = fa.flash_stats_reference(q, k, v, causal)
        acc, m, l = fa.flash_forward(q, k, v, causal, stats=True)
        fwd = max(_errs(fa.flash_forward(q, k, v, causal), o_r),
                  _errs(acc, acc_r), _errs(m, m_r), _errs(l, l_r),
                  key=lambda e: e[1])
        dlt = torch.sum(do.float() * o_r.float(), dim=-1)
        want = fa.flash_backward_reference(q, k, v, do, m_r, l_r, dlt,
                                           causal)
        dq = fa.flash_dq(q, k, v, do, m_r, l_r, dlt, causal)
        dk, dv = fa.flash_dkv(q, k, v, do, m_r, l_r, dlt, causal)
        torch.cuda.synchronize()
        e_dq = _errs(dq, want[0])
        e_dkv = max(_errs(dk, want[1]), _errs(dv, want[2]),
                    key=lambda e: e[1])
        log(f"[kernel] flash [{b}, {s}, {h}, {d}] bf16 causal={causal}: "
            f"forward {fwd[1]:.3g}, dq {e_dq[1]:.3g}, dk/dv {e_dkv[1]:.3g} "
            f"of scale (tol {tol}); max abs {fwd[0]:.3g}, {e_dq[0]:.3g}, "
            f"{e_dkv[0]:.3g}")
        for name, e in (("flash_forward", fwd), ("flash_dq", e_dq),
                        ("flash_dkv", e_dkv)):
            if not e[1] <= tol:
                raise AssertionError(f"{name} [{b}, {s}, {h}, {d}] causal="
                                     f"{causal}: {e[1]} of scale > {tol}")
            errs[name] = (max(errs[name][0], e[0]),
                          max(errs[name][1], e[1]))
        del o_r, acc_r, want, acc, dq, dk, dv
        torch.cuda.empty_cache()

    # the plain versions' times at batch 1 (the full batch's plain
    # scores would take 17 GB), the kernels' at the path's batch 8
    q1, k1, v1, do1 = inputs(1, 8192, 8, 128, 12001)
    acc1, m1, l1 = fa.flash_forward(q1, k1, v1, True, stats=True)
    o1 = (acc1 / l1[..., None]).to(cdt)
    dlt1 = torch.sum(do1.float() * o1.float(), dim=-1)
    plain = {
        "stats": event_ms(fa.flash_stats_reference, (q1, k1, v1, True), 2),
        "normalized": event_ms(fa.flash_attention_reference,
                               (q1, k1, v1, True), 2),
        "dq": event_ms(lambda *a: fa.flash_backward_reference(*a)[0],
                       (q1, k1, v1, do1, m1, l1, dlt1, True), 2),
        "dkv": event_ms(lambda *a: fa.flash_backward_reference(*a)[1:],
                        (q1, k1, v1, do1, m1, l1, dlt1, True), 2),
    }
    del q1, k1, v1, do1, acc1, m1, l1, o1, dlt1
    torch.cuda.empty_cache()

    shape = (8, 8192, 8, 128)
    q, k, v, do = inputs(*shape, 12002)
    acc, m, l = fa.flash_forward(q, k, v, True, stats=True)
    o = (acc / l[..., None]).to(cdt)
    dlt = torch.sum(do.float() * o.float(), dim=-1)
    # the path's own batch-8 launches, each batch element held against
    # the plain version on that element's inputs (batch-1 memory); the
    # backward kernels take the stats kernel's m and l and its dlt
    o_n = fa.flash_forward(q, k, v, True)
    dq = fa.flash_dq(q, k, v, do, m, l, dlt, True)
    dk, dv = fa.flash_dkv(q, k, v, do, m, l, dlt, True)
    torch.cuda.synchronize()
    for i in range(shape[0]):
        e = slice(i, i + 1)
        acc_r, m_r, l_r = fa.flash_stats_reference(q[e], k[e], v[e], True)
        fwd = max(_errs(o_n[e], fa.flash_attention_reference(
            q[e], k[e], v[e], True)), _errs(acc[e], acc_r),
            _errs(m[e], m_r), _errs(l[e], l_r), key=lambda x: x[1])
        del acc_r, m_r, l_r
        want = fa.flash_backward_reference(q[e], k[e], v[e], do[e], m[e],
                                           l[e], dlt[e], True)
        e_dq = _errs(dq[e], want[0])
        e_dkv = max(_errs(dk[e], want[1]), _errs(dv[e], want[2]),
                    key=lambda x: x[1])
        del want
        for name, er in (("flash_forward", fwd), ("flash_dq", e_dq),
                         ("flash_dkv", e_dkv)):
            if not er[1] <= tol:
                raise AssertionError(f"{name} {list(shape)} batch element "
                                     f"{i}: {er[1]} of scale > {tol}")
            errs[name] = (max(errs[name][0], er[0]),
                          max(errs[name][1], er[1]))
        log(f"[kernel] flash {list(shape)} bf16 causal, batch element {i}: "
            f"forward {fwd[1]:.3g}, dq {e_dq[1]:.3g}, dk/dv {e_dkv[1]:.3g} "
            f"of scale (tol {tol}); max abs {fwd[0]:.3g}, {e_dq[0]:.3g}, "
            f"{e_dkv[0]:.3g}")
    del acc, o_n, dq, dk, dv
    torch.cuda.empty_cache()
    kern = {
        "stats": event_ms(fa.flash_forward, (q, k, v, True, True)),
        "normalized": event_ms(fa.flash_forward, (q, k, v, True)),
        "dq": event_ms(fa.flash_dq, (q, k, v, do, m, l, dlt, True)),
        "dkv": event_ms(fa.flash_dkv, (q, k, v, do, m, l, dlt, True)),
    }
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_fwd = event_ms(lambda a, b_, c: F.scaled_dot_product_attention(
        a, b_, c, is_causal=True), (qt, kt, vt))
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (qt, kt, vt))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    gt = do.transpose(1, 2)
    lib_bwd = event_ms(lambda: torch.autograd.grad(
        out, (qg, kg, vg), gt, retain_graph=True), ())
    del out, qg, kg, vg

    rows = []
    for name, form, lib in (("flash_forward", "stats", lib_fwd),
                            ("flash_forward", "normalized", lib_fwd),
                            ("flash_dq", "dq", lib_bwd),
                            ("flash_dkv", "dkv", lib_bwd)):
        nbytes, flops = _flash_bytes_flops(*shape, True, form)
        bound, by = _bound(nbytes, flops)
        row = dict(kernel=name, form=form, shape=list(shape), dtype="bf16",
                   causal=True, ms=kern[form], plain_ms=plain[form],
                   plain_shape=[1, 8192, 8, 128], library_ms=lib,
                   library_call=("scaled_dot_product_attention(is_causal="
                                 "True) " + ("forward" if name ==
                                             "flash_forward" else
                                             "backward (dq, dk and dv "
                                             "together)")),
                   bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops,
                   tflops=flops / kern[form] / 1e9,
                   x_library=kern[form] / lib,
                   max_abs_err=errs[name][0], rel_err=errs[name][1])
        if form in FLASH_USAGE:
            use = FLASH_USAGE[form]
            row.update(design="wgmma+cp.async", regs=use["regs"],
                       spill_bytes=(use.get("spill_stores", 0)
                                    + use.get("spill_loads", 0)))
        log(f"[kernel] {name} ({form}) {shape} bf16 causal: kernel "
            f"{kern[form]:.3f} ms ({row['tflops']:.2f} TFLOP/s), plain "
            f"{plain[form]:.3f} ms at batch 1, library {lib:.3f} ms "
            f"(kernel {row['x_library']:.2f}x), "
            f"bound {bound:.3f} ms ({by}) on {card}"
            + (f"; {row['design']}, {row['regs']} registers, "
               f"{row['spill_bytes']} B spilled"
               if "design" in row else ""))
        rows.append(row)
    del q, k, v, do, m, l, o, dlt
    torch.cuda.empty_cache()
    return [("flash_forward", [r for r in rows
                               if r["kernel"] == "flash_forward"]),
            ("flash_dq", [r for r in rows if r["kernel"] == "flash_dq"]),
            ("flash_dkv", [r for r in rows if r["kernel"] == "flash_dkv"])]


def check_layer_norm_backward(card: str) -> list:
    """B4 at the path's 65,536 x 1024 f32 against its plain version."""
    import torch.nn.functional as F

    from distributed_tensorflow_example_tpu_torch.ops import fused

    rows_n, d = 8 * 8192, 1024
    g_ = _gen(13000)
    x = 2 * torch.randn(rows_n, d, generator=g_, device="cuda") + 0.5
    dy = torch.randn(rows_n, d, generator=g_, device="cuda")
    gam = 1 + 0.1 * torch.randn(d, generator=g_, device="cuda")
    got = fused.layer_norm_backward(dy, x, gam)
    want = fused.layer_norm_backward_reference(dy, x, gam)
    torch.cuda.synchronize()
    abs_err, err = max((_errs(a, b) for a, b in zip(got, want)),
                       key=lambda e: e[1])
    if not err <= LN_BWD_RTOL:
        raise AssertionError(f"layer_norm_backward: {err} of scale > "
                             f"{LN_BWD_RTOL}")
    xg = x.detach().requires_grad_(True)
    gg = gam.detach().requires_grad_(True)
    bg = torch.zeros(d, device="cuda", requires_grad=True)
    y = F.layer_norm(xg, (d,), gg, bg, eps=fused.LN_EPS)
    lib = event_ms(lambda: torch.autograd.grad(y, (xg, gg, bg), dy,
                                               retain_graph=True), (), 10)
    nbytes = 3 * rows_n * d * 4 + 3 * d * 4
    bound, by = _bound(nbytes, 15 * rows_n * d, torch.float32)
    row = dict(rows=rows_n, d=d, dtype="f32", max_abs_err=abs_err,
               rel_err=err,
               ms=event_ms(fused.layer_norm_backward, (dy, x, gam), 10),
               plain_ms=event_ms(fused.layer_norm_backward_reference,
                                 (dy, x, gam), 3),
               library_ms=lib, bound_ms=bound, bound_by=by, bytes=nbytes)
    log(f"[kernel] layer_norm_backward rows={rows_n} d={d} f32: "
        f"{err:.3g} of scale (tol {LN_BWD_RTOL}), kernel {row['ms']:.4f} "
        f"ms, plain {row['plain_ms']:.4f} ms, library {lib:.4f} ms, bound "
        f"{bound:.4f} ms ({by}) on {card}")
    return [("layer_norm_backward", [row])]


def check_grouped_ffn_z1(card: str) -> list:
    """B8's training form (``want_z1``) against its plain version at the
    path's [64, 640, 1024] x 2048, a ragged C and E = 1, and its primal
    form at the path's training and eval shapes; then timed at the
    path's shape with the four plain products of its backward."""
    from distributed_tensorflow_example_tpu_torch.models.mlp import (
        _ACTIVATIONS, dot_f32)
    from distributed_tensorflow_example_tpu_torch.ops import fused

    d, ff, cdt = 1024, 2048, torch.bfloat16
    gelu = _ACTIVATIONS["gelu"]

    def make(e, c, seed):
        # the operands as the path hands them to the kernel: the buffer
        # and the weights cast to bf16, f32 biases; z1 ~ N(0, 1)
        g = _gen(seed)
        return ("gelu", cdt,
                torch.randn(e, c, d, generator=g, device="cuda").to(cdt),
                (torch.randn(e, d, ff, generator=g, device="cuda")
                 / d ** 0.5).to(cdt),
                0.1 * torch.randn(e, ff, generator=g, device="cuda"),
                (torch.randn(e, ff, d, generator=g, device="cuda")
                 / ff ** 0.5).to(cdt),
                0.1 * torch.randn(e, d, generator=g, device="cuda"))

    worst = dict(out=(0.0, 0.0), z1=(0.0, 0.0))
    for e, c in ((64, 640), (8, 300), (1, 1000)):
        args = make(e, c, 15000 + c)
        out, z1 = fused.moe_grouped_matmul_z1(*args)
        ref_out, ref_z1 = fused.grouped_ffn_reference(*args)
        torch.cuda.synchronize()
        e_out, e_z1 = _errs(out, ref_out), _errs(z1, ref_z1)
        log(f"[kernel] grouped_ffn_z1 [{e}, {c}, {d}] ff={ff} bf16 gelu: "
            f"out {e_out[1]:.3g} of scale (tol {Z1_OUT_RTOL}), z1 "
            f"{e_z1[1]:.3g} of scale (tol {Z1_RTOL}); max abs "
            f"{e_out[0]:.3g}, {e_z1[0]:.3g}")
        if not (e_out[1] <= Z1_OUT_RTOL and e_z1[1] <= Z1_RTOL):
            raise AssertionError(f"grouped_ffn_z1 [{e}, {c}, {d}]: out "
                                 f"{e_out[1]}, z1 {e_z1[1]} of scale")
        worst = {k: (max(worst[k][0], er[0]), max(worst[k][1], er[1]))
                 for k, er in (("out", e_out), ("z1", e_z1))}
        del out, z1, ref_out, ref_z1, args
        torch.cuda.empty_cache()

    # the primal form as the path runs it, through the wrappers it calls:
    # training's C 640 and eval's C 160 (8 test examples, T 8192:
    # ceil(1.25 x 8192 / 64)), and the fp8 wrapper on f32 masters
    # against the plain version on its rounded operands
    primal = (0.0, 0.0)
    for e, c, fp8 in ((64, 640, False), (64, 160, False), (64, 160, True)):
        args = make(e, c, 15500 + c + fp8)
        if fp8:
            args = args[:2] + tuple(t.float() for t in args[2:])
            out = fused.fp8_grouped_matmul(*args)
            bq, w1q, w2q = fused._fp8_operands(args[2], args[3], args[5])
            ref_out = fused.grouped_ffn_reference(
                "gelu", cdt, bq, w1q, args[4], w2q, args[6])[0]
        else:
            out = fused.moe_grouped_matmul(*args)
            ref_out = fused.grouped_ffn_reference(*args)[0]
        torch.cuda.synchronize()
        er = _errs(out, ref_out)
        log(f"[kernel] grouped_ffn primal form [{e}, {c}, {d}] ff={ff} "
            f"bf16 gelu{' fp8' if fp8 else ''}: out {er[1]:.3g} of scale "
            f"(tol {Z1_OUT_RTOL}); max abs {er[0]:.3g}")
        if not er[1] <= Z1_OUT_RTOL:
            raise AssertionError(f"grouped_ffn primal form [{e}, {c}, {d}] "
                                 f"fp8={fp8}: out {er[1]} of scale")
        primal = (max(primal[0], er[0]), max(primal[1], er[1]))
        del out, ref_out, args
        torch.cuda.empty_cache()

    e, c = 64, 640
    args = make(e, c, 15999)
    x, w1, b1, w2, b2 = args[2:]

    def lib(act, cdt_, x_, w1_, b1_, w2_, b2_):
        # cuBLAS bf16 products with the bias folded in (bf16 out): a
        # yardstick of speed, not of the same rounding
        h = gelu(torch.baddbmm(b1_[:, None].to(cdt_), x_, w1_))
        return torch.baddbmm(b2_[:, None].to(cdt_), h, w2_)

    ms = event_ms(fused.moe_grouped_matmul_z1, args)
    primal_ms = event_ms(fused.moe_grouped_matmul, args)
    plain_ms = event_ms(fused.grouped_ffn_reference, args)
    library_ms = event_ms(lib, args)
    # the backward (no kernel in either package): its four products on
    # the path's operands, and the whole of it
    _, z1 = fused.moe_grouped_matmul_z1(*args)
    g = _gen(16000)
    cot = torch.randn(e, c, d, generator=g, device="cuda")
    dz1 = torch.randn(e, c, ff, generator=g, device="cuda")
    h1 = gelu(z1).to(cdt)
    products = {"dWe2 = h1^T g": (h1.mT, cot), "dh1 = g We2^T": (cot, w2.mT),
                "dWe1 = buf^T dz1": (x.mT, dz1),
                "dbuf = dz1 We1^T": (dz1, w1.mT)}
    bwd_ms = {k: event_ms(lambda a, b_: dot_f32(a, b_, cdt), v)
              for k, v in products.items()}
    bwd_total_ms = event_ms(fused._grouped_backward,
                            ("gelu", cdt, (x, w1, b1, w2, b2, z1), cot))
    nbytes = (e * c * d * 2 + 2 * e * d * ff * 2 + e * ff * 4 + e * d * 4
              + e * c * d * 4 + e * c * ff * 4)
    flops = 4 * e * c * d * ff
    bound, by = _bound(nbytes, flops)
    plan = _b8_plan(fused.moe_grouped_matmul_z1.last_plan, e, c, d, ff,
                    z1=True)
    row = dict(experts=e, rows=c, d=d, ff=ff, dtype="bf16",
               activation="gelu", max_abs_err=worst["z1"][0],
               rel_err=worst["z1"][1], out_max_abs_err=worst["out"][0],
               out_rel_err=worst["out"][1], primal_max_abs_err=primal[0],
               primal_rel_err=primal[1], ms=ms, primal_ms=primal_ms,
               plain_ms=plain_ms, library_ms=library_ms,
               library_call="baddbmm bf16 + gelu + baddbmm",
               bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops,
               tflops=flops / ms / 1e9, primal_tflops=flops / primal_ms / 1e9,
               x_library=ms / library_ms,
               primal_x_library=primal_ms / library_ms,
               backward_products_ms=bwd_ms, backward_ms=bwd_total_ms, **plan)
    log(f"[kernel] grouped_ffn_z1 [{e}, {c}, {d}] ff={ff} bf16: kernel "
        f"{ms:.3f} ms ({row['tflops']:.2f} TFLOP/s, {row['x_library']:.2f}x "
        f"the library; primal form {primal_ms:.3f} ms, "
        f"{row['primal_tflops']:.2f} TFLOP/s, "
        f"{row['primal_x_library']:.2f}x), plain {plain_ms:.3f} ms, library "
        f"{library_ms:.3f} ms, bound {bound:.3f} ms ({by}); backward "
        f"{bwd_total_ms:.3f} ms, products "
        + ", ".join(f"{k} {v:.3f}" for k, v in bwd_ms.items())
        + f" ms on {card}; {row['design']}, CTAs per launch {row['ctas']}, "
        f"{row['regs']} registers, {row['spill_bytes']} B spilled")
    del args, x, w1, b1, w2, b2, z1, cot, dz1, h1, products
    torch.cuda.empty_cache()
    return [("grouped_ffn_z1", [row])]


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


def phase_transformer_train(card: str) -> dict:
    """The transformer trainer at the ``transformer_wide_long`` width
    (WIDE_LONG_FLAGS, parsed as the CLI parses them) on the card."""
    from distributed_tensorflow_example_tpu_torch.config import (
        parse_train_config)
    from distributed_tensorflow_example_tpu_torch.models import (
        transformer as tfm)
    from distributed_tensorflow_example_tpu_torch.ops import fused
    from distributed_tensorflow_example_tpu_torch.train import loop

    cfg = parse_train_config(WIDE_LONG_FLAGS)
    spec = loop.make_spec(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused.reset_launch_counts()
    res, out = _run_captured(loop.run, cfg)
    torch.cuda.synchronize()
    counts = fused.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    for name in TFM_WRAPPERS:
        if counts[name] <= 0:
            raise AssertionError(f"transformer train: {name} never "
                                 f"launched on the main path")
    steps = res["steps"]
    # per step: 9 LayerNorm backwards (ln1, ln2 per block, lnf), one
    # flash dq and one dk/dv per block
    want = {"layer_norm_backward": 9 * steps, "flash_dq": 4 * steps,
            "flash_dkv": 4 * steps}
    if any(counts[k] != n for k, n in want.items()):
        raise AssertionError(f"transformer train: launches {counts}, "
                             f"expected {want}")
    costs = re.findall(r"Cost: ([^,\s]+)", out)
    if steps != 4 or len(costs) != steps + 1 or not all(
            math.isfinite(float(c)) for c in costs):
        raise AssertionError(f"transformer train: {steps} steps, printed "
                             f"costs {costs}")
    step_ms = [float(m) for m in re.findall(r"AvgTime: +(\d+\.\d+)ms",
                                            out)]
    med = statistics.median(step_ms)
    tokens = cfg.batch_size * spec.seq_len
    flops = tfm.flops_per_step(spec, cfg.batch_size)
    row = dict(steps=steps, step_ms=step_ms, step_ms_median=med,
               tokens_per_s=tokens / med * 1e3,
               model_tflops_per_s=flops / (med / 1e3) / 1e12,
               flops_per_step=flops, peak_gib=peak_gib,
               total_s=res["total_time_s"], counts=counts)
    log(f"[tfm-train] transformer_wide_long, {steps} steps of batch "
        f"{cfg.batch_size} x S {spec.seq_len} on {card}: median step "
        f"{med:.1f} ms, {row['tokens_per_s']:.0f} tokens/s, "
        f"{row['model_tflops_per_s']:.2f} model TFLOP/s "
        f"({flops / 1e12:.2f} TFLOP/step), peak memory {peak_gib:.2f} GiB; "
        f"steps {step_ms} ms; whole run incl. eval {res['total_time_s']:.2f}"
        f" s; launches {counts}")
    return row


def phase_transformer_step(card: str) -> dict:
    """One step of the full-width transformer cut to 1 block, S 2048,
    batch 2 (STEP_CHECK_FLAGS) from one initial state on the card and on
    the port's CPU path."""
    from distributed_tensorflow_example_tpu_torch.config import (
        parse_train_config)
    from distributed_tensorflow_example_tpu_torch.data import mnist
    from distributed_tensorflow_example_tpu_torch.parallel import step
    from distributed_tensorflow_example_tpu_torch.train import loop, optim
    from distributed_tensorflow_example_tpu_torch.train.state import (
        TrainState, create_train_state)

    cfg = parse_train_config(STEP_CHECK_FLAGS)
    spec = loop.make_spec(cfg)
    opt = optim.make_optimizer(cfg, 1)
    body = step.make_sync_step_body(cfg, spec, opt)
    on_card = create_train_state(spec, opt, seed=cfg.seed, device="cuda")
    cpu_params = {k: v.cpu() for k, v in on_card.params.items()}
    on_cpu = TrainState(on_card.step.cpu(), cpu_params, opt.init(cpu_params))
    batch = mnist.synthesize_split(cfg.batch_size, seed=cfg.seed,
                                   input_size=cfg.input_size)
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
        if not rel <= TFM_STEP_RTOL:
            raise AssertionError(f"transformer step: {k} update card vs "
                                 f"CPU differs by {rel} of its scale "
                                 f"{scale} > {TFM_STEP_RTOL}")
    if not math.isfinite(float(cost_card)):
        raise AssertionError(f"transformer step: cost {float(cost_card)}")
    log(f"[tfm-step] one step (1 block, S {spec.seq_len}, batch "
        f"{cfg.batch_size}, d_model {spec.d_model}) card vs CPU path: cost "
        f"{float(cost_card):.6g} vs {float(cost_cpu):.6g}, worst update "
        f"difference {worst:.3g} of its scale (tol {TFM_STEP_RTOL}); CPU "
        f"step {cpu_s:.1f} s")
    return dict(worst=worst)


def phase_moe_train(card: str) -> list:
    """The trainer at the ``moe_wide`` width (MOE_WIDE_FLAGS, parsed as
    the CLI parses them) on the card, under ``--grouped_moe`` and then
    under ``--grouped_moe --fp8_ffn``."""
    from distributed_tensorflow_example_tpu_torch.config import (
        parse_train_config)
    from distributed_tensorflow_example_tpu_torch.models import (
        transformer as tfm)
    from distributed_tensorflow_example_tpu_torch.ops import fused
    from distributed_tensorflow_example_tpu_torch.train import loop

    rows = []
    for extra in (["--grouped_moe"], ["--grouped_moe", "--fp8_ffn"]):
        cfg = parse_train_config(MOE_WIDE_FLAGS + extra)
        spec = loop.make_spec(cfg)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fused.reset_launch_counts()
        res, out = _run_captured(loop.run, cfg)
        torch.cuda.synchronize()
        counts = fused.launch_counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        what = "moe train " + " ".join(extra)
        for name in MOE_WRAPPERS:
            if counts[name] <= 0:
                raise AssertionError(f"{what}: {name} never launched on "
                                     f"the main path")
        steps = res["steps"]
        # per step and block: one training-form B8, one flash dq, one
        # flash dk/dv
        want = {"moe_grouped_matmul_z1": 2 * steps, "flash_dq": 2 * steps,
                "flash_dkv": 2 * steps}
        if any(counts[k] != n for k, n in want.items()):
            raise AssertionError(f"{what}: launches {counts}, expected "
                                 f"{want}")
        costs = re.findall(r"Cost: ([^,\s]+)", out)
        if steps != 4 or len(costs) != steps + 1 or not all(
                math.isfinite(float(c)) for c in costs):
            raise AssertionError(f"{what}: {steps} steps, printed costs "
                                 f"{costs}")
        step_ms = [float(m) for m in re.findall(r"AvgTime: +(\d+\.\d+)ms",
                                                out)]
        med = statistics.median(step_ms)
        tokens = cfg.batch_size * spec.seq_len
        flops = tfm.flops_per_step(spec, cfg.batch_size)
        row = dict(flags=extra, steps=steps, step_ms=step_ms,
                   step_ms_median=med, tokens_per_s=tokens / med * 1e3,
                   model_tflops_per_s=flops / (med / 1e3) / 1e12,
                   flops_per_step=flops, params=tfm.num_params(spec),
                   peak_gib=peak_gib, total_s=res["total_time_s"],
                   counts=counts)
        log(f"[moe-train] moe_wide {' '.join(extra)}, {steps} steps of "
            f"batch {cfg.batch_size} x S {spec.seq_len} (E "
            f"{spec.num_experts}, {row['params']} params) on {card}: "
            f"median step {med:.1f} ms, {row['tokens_per_s']:.0f} "
            f"tokens/s, {row['model_tflops_per_s']:.2f} model TFLOP/s "
            f"({flops / 1e12:.2f} TFLOP/step), peak memory {peak_gib:.2f} "
            f"GiB; steps {step_ms} ms; whole run incl. eval "
            f"{res['total_time_s']:.2f} s; launches {counts}")
        rows.append(row)
    return rows


def phase_moe_step(card: str) -> dict:
    """One step of the ``moe_wide`` widths cut to 1 block, E 8, S 256,
    batch 4, top-2 (MOE_STEP_FLAGS) from one initial state on the card
    and on the port's CPU path.  The router's choices are compared
    first: a choice flips where two probabilities tie within the bf16
    noise of the router's input, and a flipped token sends its gradient
    to another expert, so the count is printed and held to
    MOE_FLIP_LIMIT, and the CPU step then takes the card's choices (its
    own probabilities gathered at them) so that the updates compare the
    same computation."""
    from distributed_tensorflow_example_tpu_torch.config import (
        parse_train_config)
    from distributed_tensorflow_example_tpu_torch.data import mnist
    from distributed_tensorflow_example_tpu_torch.models import (
        transformer as tfm)
    from distributed_tensorflow_example_tpu_torch.parallel import step
    from distributed_tensorflow_example_tpu_torch.train import loop, optim
    from distributed_tensorflow_example_tpu_torch.train.state import (
        TrainState, create_train_state)

    cfg = parse_train_config(MOE_STEP_FLAGS)
    spec = loop.make_spec(cfg)
    opt = optim.make_optimizer(cfg, 1)
    body = step.make_sync_step_body(cfg, spec, opt)
    on_card = create_train_state(spec, opt, seed=cfg.seed, device="cuda")
    cpu_params = {k: v.cpu() for k, v in on_card.params.items()}
    on_cpu = TrainState(on_card.step.cpu(), cpu_params, opt.init(cpu_params))
    batch = mnist.synthesize_split(cfg.batch_size, seed=cfg.seed,
                                   input_size=cfg.input_size)
    x, y = torch.from_numpy(batch.images), torch.from_numpy(batch.labels)
    orig_route = tfm._route_topk
    orig_sparse = tfm._sparse_route
    card_idx, card_keep, flips = [], [], []

    def record(spec_, x_, wr, cdt):
        out = orig_sparse(spec_, x_, wr, cdt)
        card_idx.append(out[5].cpu())
        card_keep.append(out[3].cpu())
        return out

    def card_choices(spec_, probs):
        _gates, own = orig_route(spec_, probs)
        idx = card_idx[len(flips)].to(probs.device)
        flips.append(int((own != idx).any(dim=-1).sum()))
        gates = torch.gather(probs, -1, idx)
        if spec_.moe_topk > 1:
            gates = gates / torch.sum(gates, dim=-1, keepdim=True)
        return gates, idx

    try:
        tfm._sparse_route = record
        new_card, cost_card, _ = body(on_card, x.cuda(), y.cuda())
        tfm._sparse_route = orig_sparse
        tfm._route_topk = card_choices
        t0 = time.monotonic()
        new_cpu, cost_cpu, _ = body(on_cpu, x, y)
        cpu_s = time.monotonic() - t0
    finally:
        tfm._sparse_route = orig_sparse
        tfm._route_topk = orig_route
    tokens = cfg.batch_size * spec.seq_len
    dropped = int((~card_keep[0]).sum())
    log(f"[moe-step] routing card vs CPU path (1 block, E "
        f"{spec.num_experts}, top-{spec.moe_topk}, {tokens} tokens, C "
        f"{math.ceil(spec.capacity_factor * tokens * spec.moe_topk / spec.num_experts)}):"
        f" {flips[0]} tokens choose otherwise on the CPU (limit "
        f"{MOE_FLIP_LIMIT} x {tokens}); {dropped} of "
        f"{card_keep[0].numel()} units dropped on the card")
    if len(flips) != 1 or flips[0] > MOE_FLIP_LIMIT * tokens:
        raise AssertionError(f"moe step: routing differs card vs CPU on "
                             f"{flips} tokens")
    if dropped == 0:
        raise AssertionError("moe step: no unit dropped at capacity "
                             "factor 1.0")
    worst = 0.0
    for k, old in cpu_params.items():
        d_card = new_card.params[k].cpu() - old
        d_cpu = new_cpu.params[k] - old
        scale = float(d_cpu.abs().max())
        rel = float((d_card - d_cpu).abs().max()) / max(scale, 1e-30)
        worst = max(worst, rel)
        if not rel <= MOE_STEP_RTOL:
            raise AssertionError(f"moe step: {k} update card vs CPU "
                                 f"differs by {rel} of its scale {scale} "
                                 f"> {MOE_STEP_RTOL}")
    if not math.isfinite(float(cost_card)):
        raise AssertionError(f"moe step: cost {float(cost_card)}")
    log(f"[moe-step] one step (1 block, E {spec.num_experts}, S "
        f"{spec.seq_len}, batch {cfg.batch_size}, d_model {spec.d_model}, "
        f"aux weight {spec.aux_loss_weight}) card vs CPU path: cost "
        f"{float(cost_card):.6g} vs {float(cost_cpu):.6g}, worst update "
        f"difference {worst:.3g} of its scale (tol {MOE_STEP_RTOL}); CPU "
        f"step {cpu_s:.1f} s")
    return dict(worst=worst, flips=flips[0], dropped=dropped)


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
               "gemm_tc.cuh",
        replaces="distributed_tensorflow_example_tpu/ops/pallas_fused.py:"
                 "71"),
    "layer_norm_backward": dict(
        wrapper="layer_norm_backward",
        source="distributed_tensorflow_example_tpu_torch/ops/csrc/"
               "layer_norm.cu",
        replaces="distributed_tensorflow_example_tpu/ops/pallas_fused.py:"
                 "306"),
    "flash_forward": dict(
        wrapper="flash_forward",
        source="distributed_tensorflow_example_tpu_torch/ops/csrc/"
               "flash_attention_tc.cu",
        replaces="distributed_tensorflow_example_tpu/ops/flash_attention.py:"
                 "181"),
    "flash_dq": dict(
        wrapper="flash_dq",
        source="distributed_tensorflow_example_tpu_torch/ops/csrc/"
               "flash_attention_tc.cu",
        replaces="distributed_tensorflow_example_tpu/ops/flash_attention.py:"
                 "281"),
    "flash_dkv": dict(
        wrapper="flash_dkv",
        source="distributed_tensorflow_example_tpu_torch/ops/csrc/"
               "flash_attention_tc.cu",
        replaces="distributed_tensorflow_example_tpu/ops/flash_attention.py:"
                 "324"),
    # B8's training form (want_z1): the same TPU kernel, its second form
    "grouped_ffn_z1": dict(
        wrapper="moe_grouped_matmul_z1",
        source="distributed_tensorflow_example_tpu_torch/ops/csrc/"
               "grouped_ffn.cu",
        replaces="distributed_tensorflow_example_tpu/ops/pallas_fused.py:"
                 "518"),
}
# the kernels whose launches the report takes from phase 7's run
TFM_REPORT = ("layer_norm_backward", "flash_forward", "flash_dq",
              "flash_dkv")


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
                + check_mlp_forward(card) + check_flash(card)
                + check_layer_norm_backward(card)
                + check_grouped_ffn_z1(card))
    counts = phase_serve(card)
    phase_http()
    train = phase_train(card)
    phase_cli(card)
    tfm_train = phase_transformer_train(card)
    phase_transformer_step(card)
    moe_train = phase_moe_train(card)
    phase_moe_step(card)
    # each kernel's launches on its own main path: the full-width serve
    # (phase 3) for the serving kernels, the full-width MLP training run
    # (phase 5) for the MLP forward, the full-width transformer training
    # run (phase 7) for the LayerNorm backward and the flash kernels,
    # the full-width MoE run under --grouped_moe (phase 8) for B8's
    # training form
    by_path = {"serve": dict(counts), "mlp_train": train["counts"],
               "transformer_train": tfm_train["counts"],
               "moe_train": moe_train[0]["counts"],
               "moe_train_fp8": moe_train[1]["counts"]}
    counts.update({k: train["counts"][k] for k in TRAIN_WRAPPERS})
    counts.update({k: tfm_train["counts"][k] for k in TFM_REPORT})
    counts["moe_grouped_matmul_z1"] = \
        moe_train[0]["counts"]["moe_grouped_matmul_z1"]
    kernels = []
    for name, rows in measured:
        meta = KERNEL_META[name]
        head = rows[0]          # the main path's shape (decode; wide
                                # MLP; the flash stats form, training's)
        kernels.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"],
            "launches": counts[meta["wrapper"]],
            "launches_by_path": {p: c[meta["wrapper"]]
                                 for p, c in by_path.items()
                                 if c[meta["wrapper"]] > 0},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            **{k: head[k] for k in ("design", "regs", "spill_bytes",
                                    "tflops", "x_library") if k in head},
            "shapes": rows,
        })
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[done] all phases passed in {time.monotonic() - t0:.1f} s")
    log(f"[tfm-train] peak memory {tfm_train['peak_gib']:.2f} GiB, median "
        f"step {tfm_train['step_ms_median']:.1f} ms on {smi}")
    for row in moe_train:
        log(f"[moe-train] {' '.join(row['flags'])}: peak memory "
            f"{row['peak_gib']:.2f} GiB, median step "
            f"{row['step_ms_median']:.1f} ms on {smi}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
