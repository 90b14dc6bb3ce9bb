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
3b. the same model, params and requests with ``kv_quant="int8"``
    (int8 pools with f32 scale planes), run int8, bf16, bf16, int8: B2,
    B3 and B8 must launch; the medians of tokens/s, TTFT p50 and decode
    ms/tick of each pool printed, both pools' bytes read from the
    tensors, the share of
    requests whose tokens equal the bf16 pool's; the first request's
    prefill logits with the int8 pool held against the port's CPU path
    (LOGITS_ATOL), and one chained int8 paged decode step after it
    against the bf16 pool's (INT8_DECODE_ATOL);
3c. the same requests through ``moe_wide``'s MoE as an lm (E 64, top-1,
    2 blocks, d_ff 2048, 537 M expert params, bf16 over f32,
    ``--fused_ln``), decoded by dense dispatch: B2 and B3 must launch,
    B8 must not; tokens/s, TTFT p50, ms/tick and peak memory printed;
    a 16-token prompt's prefill card vs the port's CPU path, the
    routing choices first (MOE_FLIP_LIMIT), then the logits with the
    CPU path held to the card's choices (LOGITS_ATOL);
4. start the CLI's HTTP server in process on an ephemeral port and
   complete one ``POST /generate``;
4b. the same under ``--trace_spans --slo=ttft_p99_ms<=250,
    error_rate<=0.01`` with its logs in a temporary directory: GET
    ``/trace?rid=0`` (the record holds submit, admit, prefill,
    first_token and retire), ``/slo`` (the parsed specs' document) and
    ``/explain?rid=0`` (its segments tile at least 0.99 of the wall),
    every span row of the file valid;
4c. the phase 3 serve with a span recorder on and off, interleaved over
    5 rounds: the median tokens/s ratio and the host time inside the
    recorder's emit per tick printed (not gated: host-bound readings
    move between calls);
4d. one engine on the status server (phase 4b's flags plus
    ``--engine_retries=1``, its logs seeded with one metrics stream in
    the JAX package's row format): after one POST /generate, /status
    carries the engine's stats, /metrics dtx_generate_*, dtx_slo_* and
    dtx_waterfall_* gauges, /report a run report the port's schema
    accepts, /fleet an exactly-once one-source fleet report; the restart
    narrator is armed;
4e. the fleet: phase 3's 8 requests POSTed at once to one engine behind
    the status server, then to two replicas at full width behind
    ``RouterServer`` (``--replicas=2 --trace_spans --engine_retries=1``,
    one params copy): every answer 200 with its tokens, launch counters
    zeroed just before and read just after the fleet's requests (B2, B3
    and B8 must launch; the ``fleet`` path of the report), /status
    listing both replicas with health and breaker, /metrics the
    dtx_router_* gauges, the port's fleet report over replica0, replica1
    and router exactly-once; then a router over one replica, the
    requests submitted before its engine starts, bitwise equal to a bare
    engine's tokens; both serves' tokens/s and TTFT p50 printed (not
    gated);
4f. chaos: three replicas at phase 3's model, replica 0 crashing at tick
    boundaries 1-4 under ``engine_retries=1``: every request ends in a
    typed terminal, at least one failed over with its trace id, the
    fleet report is exactly-once with clean failover chains, and
    restarts.jsonl holds the narrator's valid engine_restart rows;

and for the MLP trainer (``main.py`` -> ``train/loop.run``):

2b. hold the MLP forward kernel (``mlp_forward``) against its plain
    version at the trainer's shapes — the wide one (8192 rows,
    784-4096-4096-10, relu, bf16) and the reference MLP (784-100-10,
    sigmoid, f32) at a training step's 100 rows and eval's 2000 — logits
    and hiddens, and the logits layer alone on the kernel's last hidden
    — and time it beside its plain version, a cuBLAS ``addmm`` chain and
    its bound; every row carries its design, the GEMM's registers and
    spills, TFLOP/s and the factor against the ``addmm`` chain, the f32
    rows also the split of K of each layer (a kernel entry of their own,
    ``mlp_forward_f32``, whose launches are phase 6's);
5. train at full width: the JAX repo's ``mxu_wide_pallas`` bench
   configuration (784-4096-4096-10, relu, bf16 compute over f32
   params, global batch 8192, ``--pallas``, SGD) for one epoch of 8
   steps on synthetic MNIST three ways — the default (the device-
   resident epoch, the step replayed as a CUDA graph), ``fast_loop=
   False`` (the host path) and ``fast_loop=False, device_prefetch=
   True`` — launch counters zeroed just before and read just after
   each run (``mlp_forward`` must have launched; the default run's
   counts are the path's), every printed cost finite, the two host
   paths' costs equal; print each run's median step time, examples/s
   and peak memory; then the graph's epochs timed alone after its
   capture, one epoch of the graph held bitwise against the same epoch
   run eagerly on the card (per-step costs, accuracies, final params),
   the epoch permutation at n 65,536 and 55,000 bitwise card against
   CPU, and one step from the same initial state on the card and on
   the port's CPU path, the updated params held against each other;
6. the reference command line on the card: ``main.py --pallas
   --training_epochs=1`` (784-100-10 sigmoid f32, batch 100, 550
   steps, the default fast path: B1's f32 launches counted through the
   graph's replays), its stdout held to the reference's format and its
   event file read back (550 scalar events, one graph record);

and for the transformer trainer (``main.py --model=transformer`` ->
``train/loop.run``):

2c. hold the flash forward (both forms), flash dq, flash dk/dv and the
    LayerNorm backward against their plain versions on the card — the
    attention kernels compared at [1, 8192, 8, 128] bf16 causal (the
    plain scores of the full batch would take 17 GB) and at two ragged
    shapes, timed at the path's [8, 8192, 8, 128], where each batch
    element of the timed launches' outputs is held against the plain
    version on that element's inputs; the LayerNorm
    backward at 65,536 x 1024 f32, whose row also carries the route it
    took (``variant``: "warp" or "block"), its count of dg/db partial
    rows and the time of each of its two launches (``torch.profiler``,
    after every other phase) — and time each beside its plain
    version, a PyTorch library call and its bound; the rows of the
    bf16 tensor-core forward, dq and dk/dv also carry their design,
    registers and spilled bytes (from the compiler's report of the
    loaded library's build), TFLOP/s and the factor against the library
    call;
7. train at full width: the JAX repo's ``transformer_wide_long`` bench
   configuration (causal flash attention, --fused_ln, d_model 1024, 8
   heads of 128, 4 blocks, d_ff 4096, S 8192, bf16 compute, Adam with
   bf16 moments, batch 8) for 4 steps on synthetic data with a test set
   of 8 on the default fast path (the device-resident epoch, run
   eagerly), launch counters zeroed just before and read just after
   (every kernel of the path must have launched), every printed cost
   finite; print the median step time (the run's wall over its steps,
   its first step and eval included), tokens/s, model TFLOP/s and the
   peak memory, and the step time of a warm epoch of the same runner;
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
    --fp8_ffn``, on the eager device-resident epoch; launch counters
    zeroed just before and read just after each run (B5, B6, B7, B8's
    training form and, in eval, its primal form must have launched),
    every printed cost finite; print the median step time, tokens/s,
    model TFLOP/s, the peak memory and a warm epoch's step time;
8b. one step of the same model cut to 1 block, E 8, S 256, batch 4, top-2,
    ``--moe_aux_weight=0.01`` and capacity factor 1.0 (tokens drop) from
    one initial state on the card and on the port's CPU path: the
    router's choices compared first (the count that differ printed),
    then, with the CPU step held to the card's choices, the updates held
    against each other.

The last two lines of stdout are the kernel report JSON (each kernel's
launches on its first main path, and under ``launches_by_path`` on
every path that ran it: ``serve``, ``serve_int8``, ``serve_moe``,
``fleet``, the trainers') and the result JSON; the card's name and power limit come just before them.
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
import urllib.error
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
    enough (a few hundred us or more) that host launch overhead does not
    count and whose temporaries are too large to keep one set per call
    of a CUDA graph: one warm-up call, then ``reps`` calls between CUDA
    events.  One more call is enqueued before the first event, so the
    card is busy while the host enqueues the first timed call: the
    window holds no wait for the host."""
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


def launch_us(fn, args, calls: int = 10) -> dict:
    """{kernel name: device us per call} of ``calls`` calls of
    ``fn(*args)`` under ``torch.profiler`` (CUDA activity only), after
    one call outside it: the time of each launch a call makes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    if not out:
        raise RuntimeError("the profiler recorded no device time")
    return out


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
# B4's kernels, keyed by (route, dtype), and the second launch that sums
# its dg/db partial rows; B1's f32 GEMM by its load routes (16-byte
# vectors or scalars for A, W): the reference MLP's first layer takes
# (vector, vector), its logits layer (N 10) (vector, scalar)
LN_BWD_KERNELS = {
    **{(route, dt): f"{kernel}I{mangled}EE"
       for dt, mangled in (("f32", "f"), ("bf16", "13__nv_bfloat16"))
       for route, kernel in (("warp", "ln_bwd_warp_kernel"),
                             ("block", "ln_bwd_kernel"))},
    "reduce": "ln_bwd_reduce_kernel"}
LN_BWD_USAGE: dict = {}
# (the column sum is a programmatic dependent launch: its profiled time
# starts while the row pass's last CTAs run)
LN_BWD_DESIGN = {
    "warp": "warp per row in registers, next row prefetched, shuffles, "
            "per-warp dg/db partials in shared memory, persistent grid; "
            "fixed-order column sum, dependent launch",
    "block": "CTA per row, shared memory, block reductions; fixed-order "
             "column sum, dependent launch"}
MLP_F32 = {(va, vb): f"fma_gemm_kernelILb{int(va)}ELb{int(vb)}EE"
           for va in (True, False) for vb in (True, False)}
MLP_F32_USAGE: dict = {}


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
                        (B8_TC, B8_USAGE), (LN_KERNELS, LN_USAGE),
                        (LN_BWD_KERNELS, LN_BWD_USAGE),
                        (MLP_F32, MLP_F32_USAGE)):
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
    from distributed_tensorflow_example_tpu_torch.ops import _build, fused

    reg = (d <= _build.load().dtx_layer_norm_reg_max_d() and d % 4 == 0
           and fused._vec_aligned(*tensors))
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
              (100, (100,), "sigmoid", torch.float32),
              (2000, (100,), "sigmoid", torch.float32)]
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
        else:
            # the plan of the call checked above; the layers' load routes
            # as mlp_forward.cu picks them (fresh tensors are aligned)
            _, plan = fused.mlp_forward.last_plan
            uses = [MLP_F32_USAGE[(sizes[j - 1] % 4 == 0,
                                   sizes[j] % 4 == 0)]
                    for j in range(1, L + 1)]
            row.update(design="FMA, 32x32 tiles, K split over a cluster "
                              "(DSMEM sum): (splits, CTAs) per layer "
                              f"{list(plan)}",
                       plan=[list(p) for p in plan], **_usage_row(uses))
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
    return [("mlp_forward", rows_list[:1]), ("mlp_forward_f32", rows_list[1:])]


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

    rows_n, d = LN_BWD_SHAPE
    dy, x, gam = _ln_bwd_inputs()
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
    # the plan of the call checked above (route, CTAs = dg/db partial
    # rows); the time of each of its two launches is taken last of all
    # (ln_bwd_launch_split), so that no profiler session runs before a
    # timed phase
    route, ctas = fused.layer_norm_backward.last_plan
    row = dict(rows=rows_n, d=d, dtype="f32", max_abs_err=abs_err,
               rel_err=err,
               ms=event_ms(fused.layer_norm_backward, (dy, x, gam), 10),
               plain_ms=event_ms(fused.layer_norm_backward_reference,
                                 (dy, x, gam), 3),
               library_ms=lib, bound_ms=bound, bound_by=by, bytes=nbytes,
               variant=route, partials=ctas, design=LN_BWD_DESIGN[route],
               **_usage_row([LN_BWD_USAGE[(route, "f32")],
                             LN_BWD_USAGE["reduce"]]))
    row["x_library"] = row["ms"] / lib
    log(f"[kernel] layer_norm_backward rows={rows_n} d={d} f32: "
        f"{err:.3g} of scale (tol {LN_BWD_RTOL}), kernel {row['ms']:.4f} "
        f"ms, plain {row['plain_ms']:.4f} ms, library {lib:.4f} ms (kernel "
        f"{row['x_library']:.2f}x), bound {bound:.4f} ms ({by}; kernel at "
        f"{bound / row['ms']:.1%}) on {card}; {route} route, {ctas} "
        f"partial rows; {row['design']}, {row['regs']} registers, "
        f"{row['spill_bytes']} B spilled")
    return [("layer_norm_backward", [row])]


# B4's check: the path's rows, and its inputs from one seed
LN_BWD_SHAPE = (8 * 8192, 1024)


def _ln_bwd_inputs():
    rows_n, d = LN_BWD_SHAPE
    g_ = _gen(13000)
    x = 2 * torch.randn(rows_n, d, generator=g_, device="cuda") + 0.5
    dy = torch.randn(rows_n, d, generator=g_, device="cuda")
    gam = 1 + 0.1 * torch.randn(d, generator=g_, device="cuda")
    return dy, x, gam


def ln_bwd_launch_split(card: str, row: dict) -> None:
    """The device time of each of B4's two launches at the path's shape
    (``torch.profiler``), into its report row."""
    from distributed_tensorflow_example_tpu_torch.ops import fused

    row["launches_us"] = launch_us(fused.layer_norm_backward,
                                   _ln_bwd_inputs())
    log(f"[kernel] layer_norm_backward rows={LN_BWD_SHAPE[0]} d="
        f"{LN_BWD_SHAPE[1]} f32, each launch: "
        + ", ".join(f"{k} {v:.2f} us" for k, v in row["launches_us"].items())
        + f" on {card} (the column sum's time starts at its early launch)")


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


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def _serve_requests(spec):
    """The serve's 8 ragged greedy requests: prompts of 32-300 tokens,
    32 new tokens each (both scaled with seq_len for a narrow
    rehearsal)."""
    rng = np.random.RandomState(0)
    lo, hi = 32 * spec.seq_len // 1024, 300 * spec.seq_len // 1024
    lens = [int(n) for n in rng.randint(lo, hi + 1, size=8)]
    prompts = [rng.randint(0, spec.vocab_size, size=n).tolist()
               for n in lens]
    return prompts, 32 * spec.seq_len // 1024


def pool_bytes(cache: dict) -> int:
    """The paged pool's bytes, read from its tensors (values and scale
    planes)."""
    return sum(t.numel() * t.element_size() for t in cache.values())


def serve_run(spec, params, device: str = "cuda", kv_quant: str = "",
              recorder=None) -> dict:
    """The serve's requests through a fresh ``DecodeEngine``, tick by
    tick: launch counters zeroed just before and read just after, every
    result checked (typed result, 32 tokens in the vocabulary).
    Returns the counts, tokens/s, TTFT p50, the median decode tick
    (tick 0 runs the 8 prefills and one decode; the rest decode only),
    the pool's bytes, the peak memory and the engine."""
    from distributed_tensorflow_example_tpu_torch.ops import fused
    from distributed_tensorflow_example_tpu_torch.serving.engine import (
        DecodeEngine)

    eng = DecodeEngine(spec, params, page_size=16, max_batch=8,
                       kv_quant=kv_quant, recorder=recorder, device=device)
    prompts, n_new = _serve_requests(spec)
    _sync(device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    fused.reset_launch_counts()
    t0 = time.monotonic()
    rids = [eng.submit(p, n_new) for p in prompts]
    tick_s = []
    while True:
        ts = time.monotonic()
        if not eng.step():
            break
        tick_s.append(time.monotonic() - ts)
    _sync(device)
    wall = time.monotonic() - t0
    counts = fused.launch_counts()
    results = [eng.result(r, timeout=0) for r in rids]
    for res in results:
        if res is None or res["status"] != "result" \
                or len(res["tokens"]) != n_new \
                or not all(0 <= t < spec.vocab_size for t in res["tokens"]):
            raise AssertionError(f"bad serving result: {res}")
    toks = sum(len(r["tokens"]) for r in results)
    return dict(
        counts=counts, wall=wall, tps=toks / wall,
        ttft_p50=eng.stats()["ttft_p50_ms"],
        tick_ms=float(np.median(tick_s[1:])) * 1e3,
        prefill_tick_ms=tick_s[0] * 1e3, ticks=len(tick_s),
        tokens=[r["tokens"] for r in results], prompts=prompts,
        n_new=n_new, pool_bytes=pool_bytes(eng.cache),
        peak_gib=(torch.cuda.max_memory_allocated() / 2**30
                  if device == "cuda" else 0.0), eng=eng)


def _require(counts: dict, launched, absent, label: str,
             device: str) -> None:
    """Each kernel in ``launched`` launched on the path, none in
    ``absent`` (on the card; CPU tensors take the plain versions)."""
    if device != "cuda":
        return
    for name in launched:
        if counts[name] <= 0:
            raise AssertionError(f"{name} never launched on the {label} "
                                 f"path")
    for name in absent:
        if counts[name] != 0:
            raise AssertionError(f"{name} launched {counts[name]} times on "
                                 f"the {label} path, which never reaches "
                                 f"it")


def _prefill(spec, params, prompt, dev: str, kv_quant: str = ""):
    """``prefill_into_pages`` of one prompt at its bucket on ``dev``:
    (f32 logits on the CPU, the pool)."""
    from distributed_tensorflow_example_tpu_torch.serving import (
        kv_cache as kvc)
    from distributed_tensorflow_example_tpu_torch.serving import (
        scheduler as sched_lib)

    pb = sched_lib.bucket_for(len(prompt),
                              sched_lib.shape_buckets(spec.seq_len - 1))
    wp = math.ceil(pb / 16)
    toks = np.zeros((1, pb), np.int64)
    toks[0, :len(prompt)] = prompt
    cache = kvc.init_paged_cache(spec, wp + 2, 16, quant=kv_quant,
                                 device=dev)
    logits, cache = kvc.prefill_into_pages(
        spec, params, cache, torch.arange(1, wp + 1, device=dev)[None],
        torch.from_numpy(toks).to(dev),
        torch.tensor([len(prompt)], device=dev))
    return logits.float().cpu(), cache, pb


def _check_prefill(spec, params, prompt, device: str, label: str,
                   kv_quant: str = "") -> float:
    """The prompt's prefill logits on ``device`` (kernels on the card)
    against the port's CPU path (plain versions) on the same params,
    held to LOGITS_ATOL."""
    on_dev, _, pb = _prefill(spec, params, prompt, device, kv_quant)
    on_cpu, _, _ = _prefill(spec, {k: v.cpu() for k, v in params.items()},
                            prompt, "cpu", kv_quant)
    if not (torch.isfinite(on_dev).all()
            and on_dev.shape == (1, spec.vocab_size)):
        raise AssertionError(f"{label}: prefill logits not finite / wrong "
                             f"shape")
    err = float((on_dev - on_cpu).abs().max())
    log(f"[{label}] prefill logits (prompt {len(prompt)}, bucket {pb}"
        f"{', int8 pool' if kv_quant else ''}) card vs CPU path: "
        f"max_abs_err={err:.4g} (tol {LOGITS_ATOL}), argmax equal: "
        f"{int(on_dev.argmax()) == int(on_cpu.argmax())}")
    if not err <= LOGITS_ATOL:
        raise AssertionError(f"{label}: prefill logits differ from the CPU "
                             f"path by {err} > {LOGITS_ATOL}")
    return err


def phase_serve(card: str, device: str = "cuda",
                width: dict = FULL_WIDTH) -> dict:
    from distributed_tensorflow_example_tpu_torch.models import (
        transformer as tfm)

    spec = tfm.TransformerSpec(**width, compute_dtype=torch.bfloat16)
    params = tfm.init(spec, seed=0, device=device)
    run = serve_run(spec, params, device)
    _require(run["counts"], SERVE_WRAPPERS, (), "serve", device)
    lens = [len(p) for p in run["prompts"]]
    log(f"[serve] {len(lens)} requests (prompts {min(lens)}-{max(lens)}, "
        f"{run['n_new']} new tokens, greedy) in {run['wall']:.3f} s on "
        f"{card}: {run['tps']:.1f} tokens/s, TTFT p50 "
        f"{run['ttft_p50']:.2f} ms, decode {run['tick_ms']:.3f} ms/tick "
        f"(median of {run['ticks'] - 1}), prefill tick "
        f"{run['prefill_tick_ms']:.2f} ms; launches {run['counts']}")
    # the first request's prefill logits: card (kernels) vs the port's
    # CPU path (plain versions), same params, same padded batch
    _check_prefill(spec, params, run["prompts"][0], device, "serve")
    run.pop("eng")
    return dict(run, spec=spec, params=params)


# one chained int8 paged decode step against the compute-dtype pool's on
# the same prompt and token: the bound JAX's tests/test_serving.py holds
# int8 decode to (0.1 absolute on the logits)
INT8_DECODE_ATOL = 0.1


def phase_serve_int8(card: str, base: dict, device: str = "cuda") -> dict:
    """The phase 3 model and requests with ``kv_quant="int8"``, run
    int8, bf16, bf16, int8 (phase 3's own run carries the card's
    warm-up): B2, B3 and B8 launch on both int8 runs; the medians of
    tokens/s, TTFT p50 and ms/tick of each pool, both pools' bytes and
    the share of requests whose tokens equal the bf16 pool's; the first
    request's prefill logits with the int8 pool, card vs the port's CPU
    path; one chained int8 paged decode step against the bf16 pool's."""
    from distributed_tensorflow_example_tpu_torch.serving import (
        kv_cache as kvc)

    spec, params = base["spec"], base["params"]
    runs = {"int8": [], "": []}
    for quant in ("int8", "", "", "int8"):
        r = serve_run(spec, params, device, kv_quant=quant)
        _require(r["counts"], SERVE_WRAPPERS, (),
                 "serve_int8" if quant else "serve", device)
        runs[quant].append(r)
    run = runs["int8"][0]
    if run["eng"].cache["k0"].dtype != torch.int8:
        raise AssertionError("serve_int8: the pool is not int8")
    bf16 = runs[""][0]
    same = sum(a == b for a, b in zip(run["tokens"], bf16["tokens"]))
    ratio = run["pool_bytes"] / bf16["pool_bytes"]
    med = {q: {k: float(np.median([r[k] for r in rs]))
               for k in ("tps", "ttft_p50", "tick_ms")}
           for q, rs in runs.items()}
    log(f"[serve-int8] medians of 2 runs each, int8 / bf16 pool: "
        f"{med['int8']['tps']:.1f} / {med['']['tps']:.1f} tokens/s, TTFT "
        f"p50 {med['int8']['ttft_p50']:.2f} / {med['']['ttft_p50']:.2f} ms,"
        f" decode {med['int8']['tick_ms']:.3f} / {med['']['tick_ms']:.3f} "
        f"ms/tick on {card}; pool {run['pool_bytes']} B against "
        f"{bf16['pool_bytes']} B bf16 ({ratio:.4f}; (Dh + 4) / (2 Dh) = "
        f"{(spec.d_head + 4) / (2 * spec.d_head):.4f}); {same} of "
        f"{len(run['tokens'])} requests' tokens equal the bf16 pool's; "
        f"launches {run['counts']}")
    prompt = run["prompts"][0]
    _check_prefill(spec, params, prompt, device, "serve-int8", "int8")
    # one chained decode step after the prefill, int8 pool vs bf16 pool
    steps = {}
    for quant in ("", "int8"):
        logits, cache, pb = _prefill(spec, params, prompt, device, quant)
        wp = cache["k0"].shape[0] - 2
        bt = torch.arange(1, wp + 2, device=device)[None]
        tok = torch.tensor([int(logits.argmax())], device=device)
        pos = torch.tensor([len(prompt)], device=device)
        out, _ = kvc.paged_decode_step(spec, params, cache, bt, tok, pos)
        steps[quant] = out.float().cpu()
    err = float((steps["int8"] - steps[""]).abs().max())
    log(f"[serve-int8] one chained decode step after the prefill, int8 "
        f"pool vs bf16 pool on the card: max_abs_err={err:.4g} (tol "
        f"{INT8_DECODE_ATOL}), argmax equal: "
        f"{int(steps['int8'].argmax()) == int(steps[''].argmax())}")
    if not (torch.isfinite(steps["int8"]).all() and err <= INT8_DECODE_ATOL):
        raise AssertionError(f"serve_int8: int8 decode differs from the "
                             f"bf16 pool's by {err} > {INT8_DECODE_ATOL}")
    for rs in runs.values():
        for r in rs:
            r.pop("eng")
    return dict(run, **med["int8"], bf16_warm=med[""], same=same,
                pool_ratio=ratio, decode_err=err)


# moe_wide's widths as an lm (the MoE model the port trains, phase 8):
# E 64 top-1, 2 blocks, d_ff 2048; serving routes it by dense dispatch
MOE_SERVE = dict(FULL_WIDTH, num_blocks=2, d_ff=2048, num_experts=64,
                 moe_topk=1, fp8_ffn=False)
# the short prompt whose prefill is held card vs CPU (a 16-token bucket
# keeps the CPU side's 64 experts to seconds)
MOE_CHECK_PROMPT = 16


def phase_serve_moe(card: str, device: str = "cuda",
                    width: dict = MOE_SERVE) -> dict:
    """The serve's requests through a MoE lm at ``moe_wide``'s widths:
    B2 and B3 launch, B8 never (dense dispatch computes every expert by
    plain products); tokens/s, TTFT p50, ms/tick and peak memory; a
    short prompt's prefill, card vs the port's CPU path: the top-1
    routing choices first (the flips counted and held to
    MOE_FLIP_LIMIT), then, with the CPU path held to the card's
    choices, the logits (LOGITS_ATOL)."""
    from distributed_tensorflow_example_tpu_torch.models import (
        transformer as tfm)

    spec = tfm.TransformerSpec(**width, compute_dtype=torch.bfloat16)
    params = tfm.init(spec, seed=0, device=device)
    n_expert = sum(v.numel() for k, v in params.items()
                   if k.split("_", 1)[-1] in ("We1", "We2", "be1", "be2"))
    run = serve_run(spec, params, device)
    _require(run["counts"], ("fused_layer_norm", "fused_layer_norm_residual"),
             ("moe_grouped_matmul", "moe_grouped_matmul_z1"), "serve_moe",
             device)
    log(f"[serve-moe] E {spec.num_experts} top-{spec.moe_topk}, "
        f"{spec.num_blocks} blocks, d_ff {spec.d_ff} ({n_expert / 1e6:.1f} M "
        f"expert params): {run['tps']:.1f} tokens/s, TTFT p50 "
        f"{run['ttft_p50']:.2f} ms, decode {run['tick_ms']:.3f} ms/tick, "
        f"prefill tick {run['prefill_tick_ms']:.2f} ms, peak memory "
        f"{run['peak_gib']:.3f} GiB on {card}; launches {run['counts']}")
    prompt = min(run["prompts"], key=len)[:MOE_CHECK_PROMPT]
    orig_route = tfm._route_topk
    card_idx, flips = [], []

    def record(spec_, probs):
        gates, idx = orig_route(spec_, probs)
        card_idx.append(idx.cpu())
        return gates, idx

    def card_choices(spec_, probs):
        _gates, own = orig_route(spec_, probs)
        idx = card_idx[len(flips)].to(probs.device)
        flips.append(int((own != idx).any(dim=-1).sum()))
        gates = torch.gather(probs, -1, idx)
        if spec_.moe_topk > 1:
            gates = gates / torch.sum(gates, dim=-1, keepdim=True)
        return gates, idx

    try:
        tfm._route_topk = record
        on_dev, _, pb = _prefill(spec, params, prompt, device)
        tfm._route_topk = card_choices
        t0 = time.monotonic()
        on_cpu, _, _ = _prefill(spec, {k: v.cpu() for k, v in
                                       params.items()}, prompt, "cpu")
        cpu_s = time.monotonic() - t0
    finally:
        tfm._route_topk = orig_route
    routed = pb * spec.num_blocks
    err = float((on_dev - on_cpu).abs().max())
    log(f"[serve-moe] prefill (prompt {len(prompt)}, bucket {pb}) card vs "
        f"CPU path: {sum(flips)} of {routed} routing choices differ (limit "
        f"{MOE_FLIP_LIMIT} x {routed}); with the card's choices "
        f"max_abs_err={err:.4g} (tol {LOGITS_ATOL}), argmax equal: "
        f"{int(on_dev.argmax()) == int(on_cpu.argmax())}; CPU prefill "
        f"{cpu_s:.1f} s")
    if len(flips) != spec.num_blocks or sum(flips) > MOE_FLIP_LIMIT * routed:
        raise AssertionError(f"serve_moe: routing differs card vs CPU on "
                             f"{flips} tokens")
    if not (torch.isfinite(on_dev).all() and err <= LOGITS_ATOL):
        raise AssertionError(f"serve_moe: prefill logits differ from the "
                             f"CPU path by {err} > {LOGITS_ATOL}")
    run.pop("eng")
    del params
    if device == "cuda":
        torch.cuda.empty_cache()
    return dict(run, flips=sum(flips), expert_params=n_expert)


def _post_generate(port: int, timeout: float = 300) -> dict:
    body = json.dumps({"prompt": list(range(1, 17)),
                       "max_new_tokens": 8}).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=body,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        code = resp.status
        doc = json.loads(resp.read())
    if code != 200 or doc.get("status") != "result" \
            or len(doc.get("tokens", [])) != 8:
        raise AssertionError(f"POST /generate answered {code}: {doc}")
    return doc


def _get_json(port: int, path: str):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def phase_http(flags=FULL_WIDTH_FLAGS) -> None:
    from distributed_tensorflow_example_tpu_torch import config
    from distributed_tensorflow_example_tpu_torch.serving import cli

    cfg = config.parse_config(flags + ["--serve_port=0"])
    server, engine = cli.serve(cfg, 0)
    try:
        doc = _post_generate(server.port)
    finally:
        server.close()
        engine.stop()
    log(f"[http] POST /generate -> 200, {len(doc['tokens'])} tokens, "
        f"ttft {doc['ttft_ms']} ms, latency {doc['latency_ms']} ms")


# the traced serve's flags (phase 4b); the SLO specs are the ones the
# served request is read against on /slo
TRACE_FLAGS = ["--trace_spans", "--slo=ttft_p99_ms<=250,error_rate<=0.01"]
# a waterfall's segments must tile at least this share of its wall
WATERFALL_MIN_FRAC = 0.99


def phase_http_traced(flags=FULL_WIDTH_FLAGS) -> dict:
    """The CLI's server with ``--trace_spans --slo=...`` and logs in a
    temporary directory: one POST /generate, then /trace?rid=0 (the
    record holds submit, admit, prefill, first_token and retire), /slo
    (the parsed specs' document) and /explain?rid=0 (its segments tile
    at least WATERFALL_MIN_FRAC of submit->terminal); every span row in
    the file passes the port's validator."""
    from distributed_tensorflow_example_tpu_torch import config
    from distributed_tensorflow_example_tpu_torch.obs import schema
    from distributed_tensorflow_example_tpu_torch.serving import cli

    with tempfile.TemporaryDirectory() as logs:
        cfg = config.parse_config(flags + TRACE_FLAGS + [
            "--serve_port=0", f"--logs_path={logs}"])
        server, engine = cli.serve(cfg, 0)
        try:
            doc = _post_generate(server.port)
            # the retire lands at the engine's next boundary
            deadline = time.monotonic() + 60
            while True:
                code, tr = _get_json(server.port, "/trace?rid=0")
                if code == 200 and tr["record"].get("terminal") == "result":
                    break
                if time.monotonic() > deadline:
                    raise AssertionError(f"/trace?rid=0: {code} {tr}")
                time.sleep(0.02)
            _, slo = _get_json(server.port, "/slo")
            _, ex = _get_json(server.port, "/explain?rid=0")
        finally:
            server.close()
            engine.stop()
            engine.recorder.close()
        errs = schema.validate_span_file(engine.recorder.path)
        with open(engine.recorder.path) as f:
            n_rows = sum(1 for line in f if line.strip())
    rec = tr["record"]
    missing = [e for e in ("submit", "admit", "prefill", "first_token",
                           "retire") if f"{e}_t" not in rec]
    if missing or not rec["complete"] or rec["trace_id"] != doc["trace_id"]:
        raise AssertionError(f"/trace?rid=0 record lacks {missing}: {rec}")
    if slo.get("kind") != "slo_report" or [s["name"] for s in slo["slos"]] \
            != ["ttft_p99_ms", "error_rate"] or slo["requests"] != 1:
        raise AssertionError(f"/slo: {slo}")
    wf = ex["waterfalls"]
    if len(wf) != 1 or not wf[0]["complete"]:
        raise AssertionError(f"/explain?rid=0: {ex}")
    frac = wf[0]["segment_sum_ms"] / wf[0]["wall_ms"]
    if not frac >= WATERFALL_MIN_FRAC:
        raise AssertionError(f"/explain?rid=0: segments tile {frac} of the "
                             f"wall < {WATERFALL_MIN_FRAC}")
    if errs or n_rows < 6:
        raise AssertionError(f"span file ({n_rows} rows): {errs[:5]}")
    segs = {k: v for k, v in wf[0]["segments"].items() if v}
    log(f"[http-traced] POST /generate -> 200 (ttft {doc['ttft_ms']} ms); "
        f"/trace?rid=0 complete ({len(tr['events'])} rows); /slo ok="
        f"{slo['ok']} over {slo['requests']} request(s); /explain?rid=0 "
        f"wall {wf[0]['wall_ms']} ms, segments {segs}, tiling {frac:.6f} of "
        f"it; {n_rows} span rows valid")
    return dict(frac=frac, rows=n_rows)


def _get_text(port: int, path: str) -> tuple:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=60) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _wait_retired(port: int, rid: int, timeout: float = 60.0) -> dict:
    """Poll /trace?rid=N until the request's record holds its typed
    terminal (the retire row lands at the engine's next boundary)."""
    deadline = time.monotonic() + timeout
    while True:
        code, tr = _get_json(port, f"/trace?rid={rid}")
        if code == 200 and tr["record"].get("terminal") is not None:
            return tr
        if time.monotonic() > deadline:
            raise AssertionError(f"/trace?rid={rid}: {code} {tr}")
        time.sleep(0.02)


def _metrics_fixture(logs: str) -> None:
    """One metrics stream in the JAX package's row format (a window row
    and a run_end event of a 100-step run) in ``logs``, for /report to
    fold: the port's trainer writes no metrics stream yet, and the run
    report needs one."""
    from distributed_tensorflow_example_tpu_torch.obs import schema

    t = time.time()
    window = dict(kind="window", v=schema.SCHEMA_VERSION, t=t, proc=0,
                  step=100, epoch=0, cost=1.5, path="host", steps=100,
                  window_wall_s=2.0, step_time_p50_ms=20.0,
                  step_time_p95_ms=25.0, step_time_max_ms=30.0,
                  data_wait_s=0.1, h2d_s=0.1, dispatch_s=0.5,
                  device_wait_s=1.0, ckpt_s=0.0, host_s=0.3,
                  examples_per_sec=5000.0, tokens_per_sec=None,
                  model_flops_per_step=1e9, tflops_per_sec=None, mfu=None,
                  rss_bytes=None, device_memory=None)
    end = dict(kind="event", v=schema.SCHEMA_VERSION, t=t + 0.5, proc=0,
               event="run_end", steps=100, total_time_s=2.5,
               test_accuracy=0.9, compile_s=0.2)
    with open(os.path.join(logs, "metrics.0.jsonl"), "w") as f:
        for row in (window, end):
            if schema.validate_metrics_row(row):
                raise AssertionError(schema.validate_metrics_row(row))
            f.write(json.dumps(row) + "\n")


def phase_status(flags=FULL_WIDTH_FLAGS) -> dict:
    """One engine on the status server (phase 4d): the phase 4b flags
    plus ``--engine_retries=1``, logs in a temporary directory seeded
    with one metrics stream (``_metrics_fixture``).  After one POST
    /generate: /status carries the engine's stats under ``serving``,
    /metrics at least one dtx_generate_*, dtx_slo_* and dtx_waterfall_*
    gauge, /report a run report the port's schema accepts (its restart
    summary included), /fleet a one-source fleet report that is
    exactly-once; the restart narrator is armed."""
    from distributed_tensorflow_example_tpu_torch import config
    from distributed_tensorflow_example_tpu_torch.obs import schema
    from distributed_tensorflow_example_tpu_torch.serving import cli

    with tempfile.TemporaryDirectory() as logs:
        _metrics_fixture(logs)
        cfg = config.parse_config(flags + TRACE_FLAGS + [
            "--engine_retries=1", "--serve_port=0", f"--logs_path={logs}"])
        server, engine = cli.serve(cfg, 0)
        try:
            doc = _post_generate(server.port)
            _wait_retired(server.port, doc["rid"])
            code_s, status = _get_json(server.port, "/status")
            code_m, text = _get_text(server.port, "/metrics")
            code_r, report = _get_json(server.port, "/report")
            code_f, fleet = _get_json(server.port, "/fleet")
            narrator = engine.restart_narrator
        finally:
            server.close()
            cli.stop_engines([engine])
    serving = status.get("serving") or {}
    if code_s != 200 or serving.get("completed_total") != 1 \
            or serving.get("requests_total") != 1:
        raise AssertionError(f"/status: {code_s} {status}")
    gauges = sorted({line.split()[2] for line in text.splitlines()
                     if line.startswith("# TYPE")})
    for family in ("dtx_generate_", "dtx_slo_", "dtx_waterfall_"):
        if code_m != 200 or not any(g.startswith(family) for g in gauges):
            raise AssertionError(f"/metrics ({code_m}) lacks {family}*: "
                                 f"{gauges}")
    errs = schema.validate_run_report(report)
    if code_r != 200 or errs or report.get("restarts", {}).get(
            "events") != 0:
        raise AssertionError(f"/report ({code_r}): {errs or report}")
    errs = schema.validate_fleet_report(fleet)
    if code_f != 200 or errs or not fleet["exactly_once"] \
            or len(fleet["sources"]) != 1 or fleet["requests"] != 1:
        raise AssertionError(f"/fleet ({code_f}): {errs or fleet}")
    if narrator is None:
        raise AssertionError("--engine_retries=1 armed no restart narrator")
    log(f"[status] POST /generate -> 200 (ttft {doc['ttft_ms']} ms); "
        f"/status serving completed {serving['completed_total']}; /metrics "
        f"{len(gauges)} gauges ({sum(g.startswith('dtx_generate_') for g in gauges)}"
        f" dtx_generate_*, {sum(g.startswith('dtx_slo_') for g in gauges)} "
        f"dtx_slo_*, {sum(g.startswith('dtx_waterfall_') for g in gauges)} "
        f"dtx_waterfall_*); /report valid (goodput "
        f"{report['goodput'].get('goodput_frac')}); /fleet exactly_once "
        f"over {len(fleet['sources'])} source; narrator on {narrator.path}")
    return dict(gauges=len(gauges))


def _post_many(port: int, prompts, n_new: int) -> dict:
    """POST every prompt at once (one thread each) and wait for all:
    each must come back 200 with ``n_new`` tokens.  Returns the
    responses in prompt order, the wall from the first POST to the last
    answer, tokens/s over it and the TTFT p50 of the responses."""
    import threading

    out = [None] * len(prompts)

    def one(i):
        body = json.dumps({"prompt": prompts[i],
                           "max_new_tokens": n_new}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/generate", data=body,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=300) as resp:
                out[i] = (resp.status, json.loads(resp.read()))
        except urllib.error.HTTPError as e:
            out[i] = (e.code, json.loads(e.read()))

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(prompts))]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t0
    for code, doc in out:
        if code != 200 or doc.get("status") != "result" \
                or len(doc.get("tokens", [])) != n_new:
            raise AssertionError(f"POST /generate answered {code}: {doc}")
    docs = [doc for _, doc in out]
    return dict(docs=docs, wall=wall,
                tps=sum(len(d["tokens"]) for d in docs) / wall,
                ttft_p50=float(np.median([d["ttft_ms"] for d in docs])))


def _settle(engines, timeout: float = 30.0) -> None:
    """Let each engine reach its final tick boundary (the retire row
    lands one boundary after the seal that answered the request)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all(not e.sched.live and not e.sched.waiting for e in engines):
            time.sleep(0.05)
            return
        time.sleep(0.02)


def phase_fleet(card: str, base: dict, flags=FULL_WIDTH_FLAGS,
                device: str = "cuda") -> dict:
    """The fleet (phase 4e): phase 3's 8 ragged greedy requests POSTed
    at once to one engine behind the status server, then to two
    replicas behind ``RouterServer`` (``--replicas=2 --trace_spans
    --engine_retries=1``, one params copy on the card): every answer
    200 with its tokens; the launch counters zeroed before and read
    after the fleet's requests (B2, B3 and B8 must launch: the fleet
    total, the counters being process-wide); /status lists the two
    replicas with their health and breaker, /metrics the dtx_router_*
    gauges; the port's fleet_report over replica0, replica1 and router
    is exactly-once.  Then the requests (greedy and sampled) through a
    router over one replica, submitted before its engine starts: tokens
    bitwise equal to a bare engine's.  Returns the counts and both
    serves' tokens/s and TTFT p50 (printed, not gated)."""
    from distributed_tensorflow_example_tpu_torch import config
    from distributed_tensorflow_example_tpu_torch.obs import (
        collector, schema)
    from distributed_tensorflow_example_tpu_torch.ops import fused
    from distributed_tensorflow_example_tpu_torch.serving import cli, router
    from distributed_tensorflow_example_tpu_torch.serving.engine import (
        DecodeEngine)

    spec, params = base["spec"], base["params"]
    prompts, n_new = _serve_requests(spec)
    with tempfile.TemporaryDirectory() as logs:
        cfg = config.parse_config(flags + ["--serve_port=0",
                                           f"--logs_path={logs}"])
        server, engine = cli.serve(cfg, 0)
        try:
            one = _post_many(server.port, prompts, n_new)
            one_ticks = engine.stats()["decode_ticks_total"]
        finally:
            server.close()
            cli.stop_engines([engine])
    with tempfile.TemporaryDirectory() as logs:
        cfg = config.parse_config(flags + [
            "--replicas=2", "--trace_spans", "--engine_retries=1",
            "--serve_port=0", f"--logs_path={logs}"])
        server, rt, engines = cli.serve_fleet(cfg, 0)
        try:
            _sync(device)
            fused.reset_launch_counts()
            fleet = _post_many(server.port, prompts, n_new)
            _sync(device)
            counts = fused.launch_counts()
            code_s, status = _get_json(server.port, "/status")
            code_m, text = _get_text(server.port, "/metrics")
            shared = all(engines[0].params[k] is engines[1].params[k]
                         for k in engines[0].params)
            _settle(engines)
            ticks = [e.stats()["decode_ticks_total"] for e in engines]
        finally:
            server.close()
            cli.stop_engines(engines, rt)
        rep = collector.fleet_report([os.path.join(logs, d) for d in
                                      ("replica0", "replica1", "router")])
    _require(counts, SERVE_WRAPPERS, (), "fleet", device)
    per = (status.get("router") or {}).get("per_replica") or []
    if code_s != 200 or [p.get("name") for p in per] != ["replica0",
                                                          "replica1"] \
            or not all("health" in p and "breaker" in p for p in per):
        raise AssertionError(f"fleet /status: {code_s} {status}")
    if code_m != 200 or "dtx_router_replicas 2" not in text:
        raise AssertionError(f"fleet /metrics ({code_m}) lacks "
                             f"dtx_router_*")
    if not shared:
        raise AssertionError("the replicas hold separate params copies")
    errs = schema.validate_fleet_report(rep)
    if errs or not rep["exactly_once"] or rep["requests"] != len(prompts):
        raise AssertionError(f"fleet report: {errs or rep['errors'][:5]}")
    # the router over one healthy replica is bitwise invisible
    temps = [0.9 if i % 2 else 0.0 for i in range(len(prompts))]
    toks = {}
    for routed in (False, True):
        eng = DecodeEngine(spec, params, page_size=16, max_batch=8, seed=5,
                           device=device)
        front = router.Router([eng]) if routed else eng
        rids = [front.submit(p, n_new, temperature=t)
                for p, t in zip(prompts, temps)]
        eng.start()
        try:
            toks[routed] = [front.result(r, timeout=300)["tokens"]
                            for r in rids]
        finally:
            eng.stop()
    if toks[True] != toks[False]:
        raise AssertionError("the router over one replica changed tokens")
    per_replica = [p["dispatched"] for p in per]
    log(f"[fleet] {len(prompts)} concurrent POSTs: 2 replicas (dispatched "
        f"{per_replica}, health {[p['health'] for p in per]}, decode ticks "
        f"{ticks}) {fleet['tps']:.1f} tokens/s, TTFT p50 "
        f"{fleet['ttft_p50']:.2f} ms in {fleet['wall']:.3f} s; one engine "
        f"({one_ticks} decode ticks) {one['tps']:.1f} tokens/s, TTFT p50 "
        f"{one['ttft_p50']:.2f} ms in {one['wall']:.3f} s; "
        f"launches {counts}; fleet report exactly_once over "
        f"{len(rep['sources'])} sources; router over one replica: tokens "
        f"bitwise equal to the bare engine's ({len(prompts)} requests, "
        f"{sum(t > 0 for t in temps)} sampled)")
    return dict(counts=counts, tps=fleet["tps"], ttft_p50=fleet["ttft_p50"],
                one_tps=one["tps"], one_ttft_p50=one["ttft_p50"])


def phase_chaos(card: str, base: dict, device: str = "cuda") -> dict:
    """Chaos on the card (phase 4f): three replicas at phase 3's model,
    replica 0 crashing at tick boundaries 1-4 under
    ``engine_retries=1``, behind a router with ``fleet_retries=2``,
    each with its span recorder and one restart narrator: phase 3's 8
    requests all end in a typed terminal, at least one failed over and
    kept its trace id, the port's fleet_report over the three replica
    dirs and the router's is exactly-once with clean failover chains,
    and restarts.jsonl holds the narrator's engine_restart rows, which
    the port's validator accepts."""
    from distributed_tensorflow_example_tpu_torch.obs import (
        collector, schema)
    from distributed_tensorflow_example_tpu_torch.obs.spans import (
        SpanRecorder)
    from distributed_tensorflow_example_tpu_torch.resilience import restart
    from distributed_tensorflow_example_tpu_torch.serving import router
    from distributed_tensorflow_example_tpu_torch.serving.engine import (
        DecodeEngine)
    from distributed_tensorflow_example_tpu_torch.serving.faults import (
        FaultPlan)

    spec, params = base["spec"], base["params"]
    prompts, n_new = _serve_requests(spec)
    with tempfile.TemporaryDirectory() as run_dir:
        narrator = restart.RestartNarrator(run_dir)
        recs = [SpanRecorder(os.path.join(run_dir, f"replica{i}"))
                for i in range(3)]
        router_rec = SpanRecorder(os.path.join(run_dir, "router"))
        engines = [DecodeEngine(
            spec, params, page_size=16, max_batch=8, seed=5,
            engine_retries=1, recorder=recs[i], restart_narrator=narrator,
            faults=FaultPlan(crash_at_ticks=(1, 2, 3, 4) if i == 0 else ()),
            device=device) for i in range(3)]
        for e in engines:
            e.start()
        rt = router.Router(engines, fleet_retries=2, recorder=router_rec)
        try:
            rids = [rt.submit(p, n_new) for p in prompts]
            results = [rt.result(r, timeout=300) for r in rids]
            _settle(engines)
        finally:
            for e in engines:
                e.stop()
            for rec in recs + [router_rec]:
                rec.close()
        rep = collector.fleet_report([os.path.join(run_dir, d) for d in
                                      ("replica0", "replica1", "replica2",
                                       "router")])
        rows = restart.read_restarts(run_dir)
        errs = schema.validate_restart_file(narrator.path)
        stats = rt.stats()
    terminals = [r and r.get("status") for r in results]
    if not all(t in ("result", "timeout", "shed", "failed")
               for t in terminals):
        raise AssertionError(f"chaos: untyped terminals {terminals}")
    moved = [r for r in results
             if r["status"] == "result" and r.get("failovers")]
    if not moved:
        raise AssertionError("chaos: the crash plan forced no failover")
    for r in moved:
        if r["trace_id"] != rt.trace_context(r["rid"])[0]:
            raise AssertionError(f"chaos: failover lost the trace: {r}")
    fo = rep["failover"] or {}
    if not rep["exactly_once"] or not fo.get("clean") \
            or fo.get("chains", 0) < len(moved):
        raise AssertionError(f"chaos fleet report: {rep['errors'][:5]} "
                             f"{fo}")
    if errs or not rows or {r["event"] for r in rows} != {"engine_restart"}:
        raise AssertionError(f"chaos restarts.jsonl: {errs or rows}")
    log(f"[chaos] 3 replicas, replica0 crashing at boundaries 1-4: "
        f"terminals {dict((t, terminals.count(t)) for t in set(terminals))}"
        f", {len(moved)} failed over with their trace ids, "
        f"{stats['failovers_total']} failover hops; fleet report "
        f"exactly_once, {fo.get('chains')} clean chains, {rep['restarts']} "
        f"engine restarts; restarts.jsonl {len(rows)} engine_restart rows "
        f"valid")
    return dict(moved=len(moved), restarts=len(rows))


def phase_trace_overhead(card: str, base: dict, rounds: int = 5,
                         device: str = "cuda") -> dict:
    """The phase 3 serve with a span recorder on and off, interleaved
    (off, on / on, off / ...) over ``rounds`` rounds: the median of
    each round's tokens/s on over off, and the host time spent inside
    the recorder's ``emit`` per decode tick (the instrumentation's own
    cost, read apart from the host's run-to-run noise).  Printed, not
    gated: host-bound readings move between calls."""
    from distributed_tensorflow_example_tpu_torch.obs.spans import (
        SpanRecorder)

    class TimedRecorder(SpanRecorder):
        emit_s = 0.0
        rows = 0

        def emit(self, event, **fields):
            t = time.perf_counter()
            super().emit(event, **fields)
            self.emit_s += time.perf_counter() - t
            self.rows += 1

    ratios, emit_ms, rows, tick_ms = [], [], [], []
    with tempfile.TemporaryDirectory() as logs:
        for r in range(rounds):
            tps = {}
            for traced in ((False, True) if r % 2 == 0 else (True, False)):
                rec = TimedRecorder(logs) if traced else None
                run = serve_run(base["spec"], base["params"], device,
                                recorder=rec)
                if rec is not None:
                    rec.close()
                    emit_ms.append(rec.emit_s * 1e3 / run["ticks"])
                    rows.append(rec.rows / run["ticks"])
                    tick_ms.append(run["wall"] * 1e3 / run["ticks"])
                tps[traced] = run["tps"]
            ratios.append(tps[True] / tps[False])
    out = dict(ratio=float(np.median(ratios)),
               emit_ms=float(np.median(emit_ms)),
               rows=float(np.median(rows)),
               tick_ms=float(np.median(tick_ms)))
    log(f"[trace-overhead] serve tokens/s with spans over without, "
        f"{rounds} interleaved rounds on {card}: "
        f"{', '.join(f'{x:.4f}' for x in ratios)}; median "
        f"{out['ratio']:.4f}; inside emit {out['emit_ms']:.4f} ms a tick "
        f"({out['rows']:.2f} rows a tick), "
        f"{out['emit_ms'] / out['tick_ms']:.5f} of the traced tick's wall")
    return out


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


def _wide_run(cfg, what: str) -> dict:
    """``loop.run(cfg)`` on the card with the launch counts zeroed just
    before and read just after: its counts, the median of its printed
    step times, its examples/s and its peak memory."""
    from distributed_tensorflow_example_tpu_torch.ops import fused
    from distributed_tensorflow_example_tpu_torch.train import loop

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fused.reset_launch_counts()
    res, out = _run_captured(loop.run, cfg)
    counts = _train_counts(what)
    if res["fast_loop"] != cfg.fast_loop:
        raise AssertionError(f"{what}: took fast_loop={res['fast_loop']}")
    costs = re.findall(r"Cost: ([^,\s]+)", out)
    if len(costs) != res["steps"] + 1 or not all(
            math.isfinite(float(c)) for c in costs):
        raise AssertionError(f"{what}: printed costs {costs}")
    if not re.search(r"^Test-Accuracy: \d+\.\d{2}$", out, flags=re.M):
        raise AssertionError(f"{what}: no Test-Accuracy line")
    step_ms = [float(m) for m in re.findall(r"AvgTime: +(\d+\.\d+)ms",
                                            out)]
    med = statistics.median(step_ms)
    return dict(counts=counts, step_ms_median=med, step_ms=step_ms,
                examples_per_s=cfg.batch_size / med * 1e3,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                total_s=res["total_time_s"], steps=res["steps"],
                costs=[float(c) for c in costs[:-1]])


def phase_train(card: str) -> dict:
    """The trainer at full width (WIDE_TRAIN) on the card three ways —
    the default (the device-resident epoch, the step a CUDA graph), the
    host path and the host path under --device_prefetch — then the
    graph's replays timed alone, the graph epoch held against the same
    epoch run eagerly, the permutation card against CPU, and one step
    from one initial state on the card and on the CPU."""
    import dataclasses

    from distributed_tensorflow_example_tpu_torch.config import Config
    from distributed_tensorflow_example_tpu_torch.data import mnist
    from distributed_tensorflow_example_tpu_torch.parallel import epoch, step
    from distributed_tensorflow_example_tpu_torch.train import loop, optim
    from distributed_tensorflow_example_tpu_torch.train.state import (
        TrainState, create_train_state)
    from distributed_tensorflow_example_tpu_torch.utils import prng

    cfg = Config(**WIDE_TRAIN, device="cuda")
    runs = {"graph": _wide_run(cfg, "train")}
    runs["host"] = _wide_run(dataclasses.replace(cfg, fast_loop=False),
                             "train --no_fast_loop")
    runs["host_prefetch"] = _wide_run(
        dataclasses.replace(cfg, fast_loop=False, device_prefetch=True),
        "train --no_fast_loop --device_prefetch")
    for name, r in runs.items():
        log(f"[train] {name}: {r['steps']} steps of global batch "
            f"{cfg.batch_size} ({cfg.hidden_sizes} {cfg.activation} "
            f"{cfg.compute_dtype}, --pallas) on {card}: median step "
            f"{r['step_ms_median']:.3f} ms ({r['examples_per_s']:.1f} "
            f"examples/s), steps {r['step_ms']} ms; peak memory "
            f"{r['peak_gib']:.3f} GiB; whole run incl. eval "
            f"{r['total_s']:.3f} s; launches {r['counts']}")
    if runs["host"]["costs"] != runs["host_prefetch"]["costs"]:
        raise AssertionError(f"train: --device_prefetch printed costs "
                             f"{runs['host_prefetch']['costs']} differ "
                             f"from the blocking path's "
                             f"{runs['host']['costs']}")

    # the same device-resident epoch three epochs more: the graph's
    # replays timed alone (the run's AvgTime above includes the warm-up
    # and the capture, as JAX's includes its compile), and, from one
    # state, the graph's per-step costs against the eager epoch's
    spec = loop.make_spec(cfg)
    opt = optim.make_optimizer(cfg, runs["graph"]["steps"])
    data = mnist.synthesize_split(cfg.synthetic_train_size, seed=1)
    img, lbl, spe = epoch.shard_dataset(data.images, data.labels,
                                        cfg.batch_size, "cuda")
    key = prng.PRNGKey(cfg.seed + epoch.SHUFFLE_SALT)
    start = create_train_state(spec, opt, seed=cfg.seed, device="cuda")
    graph = epoch.build_epoch_runner(cfg, spec, opt, spe, "cuda")
    eager = epoch._EagerRunner(cfg, spec, opt, spe, 1)
    g_state, g_costs, g_accs = graph(epoch._clone_state(start), img, lbl,
                                     key, 0)
    e_state, e_costs, e_accs = eager(epoch._clone_state(start), img, lbl,
                                     key, 0)
    e_costs, e_accs = e_costs[0], e_accs[0]
    if not (torch.equal(g_costs, e_costs) and torch.equal(g_accs, e_accs)):
        raise AssertionError(f"train: the graph epoch's costs "
                             f"{g_costs.tolist()} differ from the eager "
                             f"epoch's {e_costs.tolist()}")
    for k in g_state.params:
        if not torch.equal(g_state.params[k], e_state.params[k]):
            raise AssertionError(f"train: graph vs eager epoch, {k} "
                                 f"differs")
    del e_state, eager
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    replay_ms = []
    for e in range(1, 4):
        ev[0].record()
        g_state, _c, _a = graph(g_state, img, lbl, key, e)
        ev[1].record()
        torch.cuda.synchronize()
        replay_ms.append(ev[0].elapsed_time(ev[1]) / spe)
    replay_med = statistics.median(replay_ms)
    log(f"[train] graph epoch vs the same epoch run eagerly on the card: "
        f"{spe} per-step costs and accuracies and the final params "
        f"bitwise equal (tol 0); the graph's epochs after the capture: "
        f"{[round(t, 4) for t in replay_ms]} ms a step (shuffle "
        f"included), median {replay_med:.4f} ms ("
        f"{cfg.batch_size / replay_med * 1e3:.1f} examples/s) on {card}")
    del g_state, graph
    for n in (65536, 55000):
        k = prng.fold_in(prng.fold_in(key, 0), 0)
        if not torch.equal(prng.permutation(k, n, "cuda").cpu(),
                           prng.permutation(k, n, "cpu")):
            raise AssertionError(f"train: permutation of {n} differs "
                                 f"card vs CPU")
    log("[train] the epoch permutation at n 65536 and 55000: card and "
        "CPU bitwise equal")

    body = step.make_sync_step_body(cfg, spec, opt)
    on_card = start
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
    return dict(counts=runs["graph"]["counts"], runs=runs,
                replay_ms_median=replay_med, replay_ms=replay_ms)


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
    step_ms = [float(m) for m in re.findall(r"AvgTime: +(\d+\.\d+)ms",
                                            out)]
    log(f"[cli] reference format, 550 steps, {len(events)} events read back "
        f"on {card}; AvgTime {step_ms} ms a step; launches {counts}")
    return dict(counts=counts, step_ms=step_ms)


def _epoch_step_ms(cfg) -> float:
    """The device-resident epoch of ``cfg`` through the runner the
    trainer builds (the MLP's step a CUDA graph, the transformer's
    eager), from a fresh state: one epoch to warm up, then one timed
    with CUDA events; ms a step, the epoch's shuffle included.  The
    run's own ``AvgTime`` averages its first step and its eval into
    every step, as the JAX fast path's does."""
    from distributed_tensorflow_example_tpu_torch.data import mnist
    from distributed_tensorflow_example_tpu_torch.parallel import epoch
    from distributed_tensorflow_example_tpu_torch.train import loop, optim
    from distributed_tensorflow_example_tpu_torch.train.state import (
        create_train_state)
    from distributed_tensorflow_example_tpu_torch.utils import prng

    spec = loop.make_spec(cfg)
    data = mnist.synthesize_split(cfg.synthetic_train_size, seed=1,
                                  input_size=cfg.input_size)
    img, lbl, spe = epoch.shard_dataset(data.images, data.labels,
                                        cfg.batch_size, "cuda")
    opt = optim.make_optimizer(cfg, 2 * spe)
    state = create_train_state(spec, opt, seed=cfg.seed, device="cuda")
    run = epoch.build_epoch_runner(cfg, spec, opt, spe, "cuda")
    key = prng.PRNGKey(cfg.seed + epoch.SHUFFLE_SALT)
    state, _c, _a = run(state, img, lbl, key, 0)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    state, costs, _a = run(state, img, lbl, key, 1)
    ev[1].record()
    torch.cuda.synchronize()
    if not torch.isfinite(costs).all():
        raise AssertionError(f"epoch runner: costs {costs.tolist()}")
    return ev[0].elapsed_time(ev[1]) / spe


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
    epoch_ms = _epoch_step_ms(cfg)
    row = dict(steps=steps, step_ms=step_ms, step_ms_median=med,
               epoch_step_ms=epoch_ms,
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
        f" s; launches {counts}; the device-resident epoch after a warm "
        f"one: {epoch_ms:.2f} ms a step")
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
        epoch_ms = _epoch_step_ms(cfg)
        row = dict(flags=extra, steps=steps, step_ms=step_ms,
                   epoch_step_ms=epoch_ms,
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
            f"{res['total_time_s']:.2f} s; launches {counts}; the "
            f"device-resident epoch after a warm one: {epoch_ms:.2f} ms a "
            f"step")
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
    # B1's f32 layers (the reference MLP, phase 6's run): the same TPU
    # kernel, its f32 form
    "mlp_forward_f32": dict(
        wrapper="mlp_forward", path="mlp_cli",
        source="distributed_tensorflow_example_tpu_torch/ops/csrc/"
               "mlp_forward.cu",
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
    serve = phase_serve(card)
    counts = dict(serve["counts"])
    serve_int8 = phase_serve_int8(card, serve)
    serve_moe = phase_serve_moe(card)
    phase_http()
    phase_http_traced()
    phase_status()
    fleet = phase_fleet(card, serve)
    phase_chaos(card, serve)
    trace = phase_trace_overhead(card, serve)
    del serve["params"]
    torch.cuda.empty_cache()
    train = phase_train(card)
    cli = phase_cli(card)
    tfm_train = phase_transformer_train(card)
    phase_transformer_step(card)
    moe_train = phase_moe_train(card)
    phase_moe_step(card)
    ln_bwd_launch_split(card, dict(measured)["layer_norm_backward"][0])
    # each kernel's launches on its own main path: the full-width serve
    # (phase 3) for the serving kernels (the int8 and MoE serves, phases
    # 3b and 3c, under launches_by_path), the full-width MLP training run
    # (phase 5) for the MLP forward, the full-width transformer training
    # run (phase 7) for the LayerNorm backward and the flash kernels,
    # the full-width MoE run under --grouped_moe (phase 8) for B8's
    # training form
    by_path = {"serve": dict(counts), "serve_int8": serve_int8["counts"],
               "serve_moe": serve_moe["counts"],
               "fleet": fleet["counts"],
               "mlp_train": train["counts"],
               "mlp_cli": cli["counts"],
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
            "launches": (by_path[meta["path"]] if "path" in meta
                         else counts)[meta["wrapper"]],
            "launches_by_path": {p: c[meta["wrapper"]]
                                 for p, c in by_path.items()
                                 if c[meta["wrapper"]] > 0},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            **{k: head[k] for k in ("design", "regs", "spill_bytes",
                                    "tflops", "x_library", "variant",
                                    "partials", "launches_us", "plan")
               if k in head},
            "shapes": rows,
        })
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[done] all phases passed in {time.monotonic() - t0:.1f} s")
    for name, r in (("bf16 pool (first run)", serve),
                    ("bf16 pool (warm, median of 2)",
                     dict(serve_int8["bf16_warm"],
                          pool_bytes=serve["pool_bytes"],
                          peak_gib=serve["peak_gib"])),
                    ("int8 pool (median of 2)", serve_int8),
                    ("MoE, bf16 pool", serve_moe)):
        log(f"[serve] {name}: {r['tps']:.1f} tokens/s, TTFT p50 "
            f"{r['ttft_p50']:.2f} ms, {r['tick_ms']:.3f} ms/tick, pool "
            f"{r['pool_bytes']} B, peak memory {r['peak_gib']:.3f} GiB on "
            f"{smi}")
    log(f"[fleet] 2 replicas behind the router, 8 concurrent POSTs: "
        f"{fleet['tps']:.1f} tokens/s, TTFT p50 {fleet['ttft_p50']:.2f} ms; "
        f"one engine behind the status server: {fleet['one_tps']:.1f} "
        f"tokens/s, TTFT p50 {fleet['one_ttft_p50']:.2f} ms on {smi}")
    log(f"[serve] int8 pool / bf16 pool bytes {serve_int8['pool_ratio']:.4f}"
        f"; tokens equal in {serve_int8['same']} of 8 requests; spans on / "
        f"off tokens/s median {trace['ratio']:.4f}, inside emit "
        f"{trace['emit_ms']:.4f} ms a tick on {smi}")
    for name, r in train["runs"].items():
        log(f"[train] {name}: median step {r['step_ms_median']:.3f} ms, "
            f"peak memory {r['peak_gib']:.3f} GiB on {smi}")
    log(f"[train] graph replays alone: median step "
        f"{train['replay_ms_median']:.4f} ms on {smi}")
    log(f"[tfm-train] peak memory {tfm_train['peak_gib']:.2f} GiB, median "
        f"step {tfm_train['step_ms_median']:.1f} ms, warm epoch "
        f"{tfm_train['epoch_step_ms']:.2f} ms a step on {smi}")
    for row in moe_train:
        log(f"[moe-train] {' '.join(row['flags'])}: peak memory "
            f"{row['peak_gib']:.2f} GiB, median step "
            f"{row['step_ms_median']:.1f} ms, warm epoch "
            f"{row['epoch_step_ms']:.2f} ms a step on {smi}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
