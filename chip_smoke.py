"""Smoke run of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py

Phases (any failure exits nonzero; none is caught and skipped):

1. build the CUDA kernels from ``distributed_tensorflow_example_tpu_
   torch/ops/csrc`` with nvcc for sm_90a, and print the build time and
   each kernel's registers and spills from the compiler's report, which
   must name no kernel whose wgmma products it serialized;
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
4g. workload replay: a synthetic workload of 16 requests (shared-prefix
    groups, 30 s relative deadlines) replayed through ``dtx-serve
    --replay`` (``serving/cli.main`` in process, phase 3's model, the
    engines warmed up before the replay's clock) twice under
    ``--trace_spans`` at x2 and once with ``--replicas=2``: exit 0 with
    the report alone on stdout, no wedged or failed terminal, equal
    terminal multisets, B2, B3 and B8 launched (the ``replay`` path),
    every span row stamped ``replay_of``, the first replay's stream
    re-captured to the input's schedule and the id round-tripped through
    ``replay_sim``, every submit at most 0.5 s behind its schedule;
    tokens/s of each replay, the determinism_frac of the two one-engine
    replays and the tick batch sizes of any mismatching request printed
    (not gated);

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
5b. the resilience store at the same widths under ``--ckpt_every=2``
    (host path): two uninterrupted runs with bitwise equal final
    snapshots, the second also writing a classic ``--sharded_checkpoints
    --async_checkpoints`` checkpoint restored bitwise; the trainer in a
    subprocess, SIGTERM'd once its step-4 snapshot is valid, exiting 143
    through ``Preempted`` with a ``preempt`` row in restarts.jsonl; a
    ``--resume=auto`` relaunch ending bitwise equal to the uninterrupted
    run; B1 launched in each in-process run (the ``resilience`` paths);
    the loop's stall per snapshot (``ckpt_stall_ms``), the writer's
    mean write ms and the snapshot's bytes printed;
5c. the trainer's monitoring: the same widths on the graph path under
    ``--metrics --log_every=4 --flight --on_anomaly=skip --status_port``
    (the step still captured, B1's launches phase 5's, every metrics row
    valid with 0 < mfu <= 1, /status and /metrics polled while it runs,
    the final params bitwise a run without the flags); the blow-up
    (``--learning_rate=1e30 --naive_ce``) skipped on the graph path
    (skipped steps >= 1, every param finite, the first flagged step
    printed) and halted on the host path (``AnomalyError`` inside the
    epoch, a valid ``flight/0.json`` blaming real leaves and
    ``flight/report.json``); the skip mask's cost over 3 interleaved
    rounds of the graph epoch and ``--histograms``' on the host path,
    printed; ``transformer_wide_long`` under ``--metrics
    --profile_steps=1:2``: its Chrome trace names the bf16 flash kernels
    and the trace scopes, its rows' MFU printed;
5d. data parallelism, in its own process: ``cluster.bootstrap`` sets up
    a one-rank NCCL group from ``--coordinator_address
    --num_processes=1``, and in it the same widths under Adam train 8
    steps six ways through ``loop.run``: plain (graph and host path),
    ``--zero_opt`` (host), ``--fsdp`` (graph and host),
    ``--sync_period=2`` (graph); each run's final params bitwise the
    plain run's on its path (``--sync_period=2``; ZeRO-1 and FSDP
    within DP_PARAMS_RTOL), B1's launches the plain run's (11 on the
    graph path), the all-gather, reduce-scatter and all-reduce named in
    a ``torch.profiler`` window over the FSDP step; each strategy's step
    ms on CUDA events, peak memory and collectives' device ms printed;
5e. tensor parallelism at ``--model_parallel=2`` on two gloo ranks on
    the one card (NCCL refuses two ranks on one device; gloo stages CUDA
    tensors through host memory, so the step times are gloo-bound, not
    TP's across cards): each rank a subprocess (``chip_smoke.py
    --tp-phase ARGS RANK``) that sets up the gloo group, which
    ``loop.run`` finds up and leaves; ``transformer_wide_long`` cut to 2
    blocks and batch 2 (3 steps, a test set of 2) plain, ``--fsdp`` and
    ``--zero_opt``, and WIDE_TRAIN on the host path, each against a
    one-rank run of the same flags in this process: every printed cost
    within TP_COST_RTOL, the gathered final params within the Adam or
    SGD bound (TP_ADAM_STEP, TP_SGD_RTOL), B2-B7 launched in every
    transformer rank with B5-B7 on 4 heads (the wrappers' last shapes),
    B1 0 times in the TP MLP run and 13 in its one-rank host run, the
    captured MLP epoch refusing the gloo group; prints each run's step
    ms (host clock), peak memory and params held per rank;
5f. multi-site local SGD at ``--sites 2`` on two gloo ranks on the one
    card (rank r is site r; each a subprocess, ``chip_smoke.py
    --site-phase ARGS RANK``): WIDE_TRAIN on the host path at
    ``--inner_steps 4`` with the Nesterov outer step for 8 rounds, the
    same under ``--outer_quant int8``, and ``transformer_wide_long``
    cut to 2 blocks and batch 4 at ``--inner_steps 2`` (2 rounds); every
    cost finite, both sites' params bitwise equal after every round,
    the outer sync's payload the f32 pseudo-gradient of ``obs/flops``'
    closed form, B1 launched in every rank of the MLP runs and B2-B7 in
    every rank of the transformer's; then, on seeded batches at the same
    MLP widths with SGD inner steps, ``--inner_steps 1`` with outer SGD
    at lr 1 against the synchronous step at dp 2 and ``--inner_steps
    4`` against ``--sync_period 4``, each within SITE_EQUIV_RTOL; prints
    each run's round and outer-sync ms (host clock: gloo's staging, not
    a deployment's), the bytes a round beside the closed forms, and the
    peak memory;
5g. sequence parallelism at ``--sequence_parallel 2`` on two gloo ranks
    on the one card (each a subprocess, ``chip_smoke.py --sp-phase ARGS
    RANK``): ``transformer_wide_long`` at phase 5e's cut on the host
    path, under the ring and under Ulysses, against a one-rank run of
    the same flags in this process: every printed cost within
    SP_COST_RTOL, rank 0's final params within phase 5e's Adam bound,
    each rank's first-step gradients (summed over the seq group) within
    SP_GRAD_RTOL of the one-rank run's, B2-B7 launched in every rank and
    B5-B7 exactly SP_LAUNCHES times at the rank's shape (the ring's rank
    0 runs the diagonal block, rank 1 the diagonal and the past block),
    the bytes a step posted to the seq axis's collectives equal to the
    closed form, and the bytes the loopback carried during one block's
    attention, forward and backward, within SP_WIRE_OVER of what both
    ranks posted (gloo cannot send a CUDA tensor point to point, so
    there the ring rotates by a zero-split ``all_to_all_single``); then B5's stats form, B6 and B7 at the
    ring's non-causal past block and causal diagonal block [2, 4096, 8,
    128] and at Ulysses' [2, 8192, 4, 128], each against its plain
    version within FLASH_TOL and timed beside it, SDPA and its bound
    (rows added to the flash kernels' report); prints each rank's
    launches, bytes, warm step ms (host clock) and peak memory beside
    the one-rank run's, with the card's name and power limit;
5h. expert parallelism at ``--expert_parallel 2`` (dp 1) on two gloo
    ranks on the one card (each a subprocess, ``chip_smoke.py
    --ep-phase ARGS RANK``), each run against a one-rank run of the
    same flags in this process, all on the host path: ``moe_wide``
    under ``--grouped_moe`` for 3 steps at full width (each rank 32 of
    the 64 experts, B8's training form once a block a step at [32, 640,
    1024] x 2048, B5-B7 on the rank's [16, 1024, 8, 128]; costs within
    EP_WIDE_COST_RTOL, since each token shard fills its own capacity),
    and a 1-block E 8 cut at ample capacity (cf 8), sparse and dense,
    whose costs are held within EP_COST_RTOL and whose first-step
    gradients (each rank's experts against their slice) within
    EP_GRAD_RTOL; every run's bytes a step posted to the expert axis
    equal to the closed form and its replicated leaves bitwise equal
    across the ranks after every step; one wide block's exchanges'
    loopback bytes within EP_WIRE_OVER of what the ranks sent off their
    own; then B8's training form at [32, 640, 1024] x 2048 and B5-B7 at
    [16, 1024, 8, 128] against their plain versions, timed beside the
    library and the bound (rows added to the report); prints each
    rank's launches, B8's plan and shape, bytes, errors, warm step ms
    (host clock: gloo's staging), params held and peak memory beside
    the one-rank run's, with the card's name and power limit;
5i. pipeline parallelism at ``--pipeline_parallel 2`` (dp 1) on two
    gloo ranks on the one card (each a subprocess, ``chip_smoke.py
    --pp-phase ARGS RANK``): ``transformer_wide_long`` at full width and
    depth (4 blocks, batch 8) on the host path, 4 microbatches, 3 steps,
    under GPipe, 1F1B and interleaved 1F1B (2 virtual stages, one block a
    chunk), each against a one-rank run of the same flags without the
    stage axis in this process: every printed cost within PP_COST_RTOL,
    each rank's first-step gradients (its stage's slice of the stacked
    leaves) within PP_GRAD_RTOL of the one-rank run's, the replicated
    leaves bitwise equal across the ranks after every step, the bytes a
    step posted to the stage hops equal to the closed form, B2-B7
    launched exactly as predicted (B5 twice a slot under 1F1B) and
    B5-B7 at the microbatch's [2, 8192, 8, 128]; then B5's stats form,
    B6 and B7 at [2, 8192, 8, 128] causal against their plain versions,
    timed beside SDPA and the bound (rows added to the report); prints
    each rank's launches, bytes, errors, warm step ms (host clock:
    gloo's staging, not PP across cards) and peak memory beside the
    one-rank run's, with the card's name and power limit;
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
    shapes, then at the wide head dims (FLASH_WIDE_CASES: bf16 [1, 8192,
    4, 256] and [2, 1000, 4, 256] causal, [1, 512, 2, 192] non-causal;
    f32 [1, 1024, 2, 256] and [1, 300, 2, 200] causal), timed at the
    path's [8, 8192, 8, 128] and at phase 7c's [8, 8192, 4, 256], where
    each batch element of the timed launches' outputs is held against
    the plain version on that element's inputs; the LayerNorm
    backward at 65,536 x 1024 f32, whose row also carries the route it
    took (``variant``: "warp" or "block"), its count of dg/db partial
    rows and the time of each of its two launches (``torch.profiler``,
    after every other phase; null where the profiler's window lost
    the card's events) — and time each beside its plain
    version, a PyTorch library call and its bound; the rows of the
    bf16 tensor-core forward, dq and dk/dv (narrow and wide) also carry
    their design, registers and spilled bytes (from the compiler's report
    of the
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
    updates held against each other;
7c. phase 7's run at 4 heads of 256 (WIDE_HEAD_FLAGS: the same params
    and FLOPs, the head geometry of Gemma's head_dim 256), so B5-B7 take
    their wide instantiations: the same launch counts and checks as
    phase 7, B6 and B7 last at [8, 8192, 4, 256] and B5 at the eval
    chunk's [4, 8192, 4, 256]; the median step, tokens/s, model TFLOP/s
    and peak memory printed;
7d. phase 7b's step at 4 heads of 256, card vs CPU path, within
    TFM_STEP_RTOL.

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

and for the operator's read side (``python -m
distributed_tensorflow_example_tpu_torch.obs.cli``, ``dtx-obs``):

9.  ``dtx-obs`` over the streams phases 4b, 4d-4g and 5c wrote on the
    card, kept in one temporary directory (``_keep``) that the phase
    removes: ``validate`` of every run directory, ``report`` (MFU in
    (0, 1] at the card's peak), ``tail`` (a line a window row),
    ``compare`` of the monitored MLP run and ``transformer_wide_long``
    both ways on their step-time medians (exit 3 where the candidate is
    the slower by more than 5%, 0 the other way), ``slo``, ``trace`` and
    ``trace --export chrome`` of the traced serve (every request id in
    the Chrome JSON), ``explain [--fleet]`` of a replay, ``collect`` and
    ``fleet`` of the fleet and chaos runs (exactly-once, exit 0),
    ``capture`` then ``capacity`` at the replay's measured tokens/s and
    completed requests a second (the exit code its verdict implies; the
    forecast and the roofline ceiling at the card's HBM peak printed
    beside the measured tokens/s), ``history --append`` of five run
    reports, ``drift`` and ``drift --capture`` (the card's HBM peak in
    the join), ``serve`` answering /status, /metrics and /report and
    stopped; each through ``obs.cli.main`` with its exit code checked,
    each printed with its wall and the card's name and power limit.

and for the last modules (the port's ``dtx-lint``, ``native`` and the
MNIST download):

10. (a) the port's ``dtx-lint`` (``analysis.cli``) over the port's package
    on this machine: exit 0 and ``--json`` ``"ok": true`` against its
    baseline, its module count and wall printed; a planted tree with
    one torch-form violation of each rule exits 1 naming all nine;
    (b) ``native``: the g++ library builds (``native_available()``),
    CRC32C's check value, ``masked_crc32c`` equal to the Python table's
    on a 1 MiB seeded buffer, ``gather_batch`` and ``u8_to_f32_scaled``
    bitwise equal to numpy's form of the same arithmetic; one 100-row
    gather from 55,000 x 784 f32 and the CRC32C rate timed, native
    against numpy / Python; (c) four gz IDX files at MNIST's sizes
    (60,000 and 10,000 images of 28 x 28, the synthetic digits of
    ``--seed``) served by an in-process ``http.server`` on 127.0.0.1
    behind a corrupt first mirror, which ``download_file`` rejects by
    each file's SHA-256 before it takes the good one; the reference
    MLP (``--pallas``, 784-100-10 f32) trained one epoch on them with
    ``--dataset=mnist`` on the host path (``--no_fast_loop``) and on
    the fast path, B1's
    launches as predicted, every cost finite; then ``--dataset=mnist
    --mnist_mirrors http://127.0.0.1:<port>/`` into an empty directory
    in a subprocess, which the published digests refuse: exit 1 with
    JAX's ``FileNotFoundError``.  Nothing is fetched from outside the
    machine.

The last two lines of stdout are the kernel report JSON (each kernel's
launches on its first main path, and under ``launches_by_path`` on
every path that ran it: ``serve``, ``serve_int8``, ``serve_moe``,
``fleet``, ``replay``, the trainers', ``resilience``,
``resilience_resumed``, phase 5c's ``monitoring`` runs, phase 5d's
``dp_*`` runs, phase 5e's ``tp_*`` runs, each rank's and the one-rank
reference's, phase 5f's ``site_*`` runs, each rank's, phase 5g's
``sp_*`` runs, each rank's and ``sp_one_rank``, phase 5h's ``ep_*``
runs, each rank's and the one-rank run's, and phase 10's ``mnist_host``
and ``mnist_fast`` runs; the flash kernels' and B8's
training form's ``shapes`` also hold phase 5g's and 5h's forms) and the
result JSON; the card's name and power limit
come just before them.
The script imports nothing of JAX; it needs one card and exits
nonzero without one.
"""

from __future__ import annotations

import atexit
import contextlib
import datetime
import glob
import io
import json
import math
import os
import re
import shutil
import signal
import socket
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
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
# phases 7c and 7d: the same runs at 4 heads of 256 (Gemma's head dim):
# the params and FLOPs of phases 7 and 7b, so a step-time difference is
# the head geometry's alone; B5-B7 take their wide instantiations
WIDE_HEAD_FLAGS = [f.replace("--n_heads=8", "--n_heads=4")
                   for f in WIDE_LONG_FLAGS]
WIDE_HEAD_STEP_FLAGS = [f.replace("--n_heads=8", "--n_heads=4")
                        for f in STEP_CHECK_FLAGS]

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


def launch_us(fn, args, calls: int = 10, tries: int = 3):
    """``(split, call_us)``: the device us of one ``fn(*args)`` call
    between CUDA events, and ``{kernel name: device us per call}`` of
    ``calls`` calls under ``torch.profiler`` (CUDA activity only), the
    time of each launch a call makes.  A window counts only where it
    holds every launch of the ``calls`` calls: CUPTI has dropped some or
    all of a late window's kernels in a process that had traced before.
    Such a window is taken again, up to ``tries`` times; then ``split``
    is None (not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call_us = event_ms(fn, args, reps=calls) * 1e3
    seen = []
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn(*args)
            torch.cuda.synchronize()
        out, counts = {}, []
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA:
                continue
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = getattr(ev, "self_cuda_time_total", 0.0)
            out[ev.key[:80]] = us / calls
            counts.append(ev.count)
        seen.append(counts)
        if out and all(c == calls for c in counts):
            return out, call_us
    log(f"[kernel] the profiler's {tries} windows held {seen} of each "
        f"kernel's {calls} launches (a call {call_us:.2f} us by CUDA "
        f"events): each launch's time not measured")
    return None, call_us


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


def wgmma_serialized(text: str) -> list:
    """The kernels whose wgmma products the compiler's ``-Xptxas -v``
    report says it serialized (its "Potential Performance Loss" notes:
    a product waits for the one before, so none overlaps other work)."""
    return sorted(set(re.findall(
        r"wgmma\.mma_async instructions are serialized.*? in the function "
        r"'([\w$]+)'", text)))


# the bf16 tensor-core kernels behind B5's two forms, B6 and B7 at the
# path's causal shape and behind B1's bf16 layers (fragments of their
# mangled names), and their registers and spills from the compiler's
# report of the loaded library's build (phase 1)
FLASH_TC = {"stats": "flash_fwd_tc_kernelILb1ELb1EE",
            "normalized": "flash_fwd_tc_kernelILb1ELb0EE",
            "dq": "flash_dq_tc_kernelILb1EE",
            "dkv": "flash_dkv_tc_kernelILb1EE"}
# the same kernels as a profiler's trace names them (demangled)
FLASH_TC_DEMANGLED = {"stats": "flash_fwd_tc_kernel<true, true>",
                      "normalized": "flash_fwd_tc_kernel<true, false>",
                      "dq": "flash_dq_tc_kernel<true>",
                      "dkv": "flash_dkv_tc_kernel<true>"}
FLASH_USAGE: dict = {}
# the wide instantiations (128 < D <= 256) of every form, keyed by
# (dtype, form, causal): bf16 the *_wide_tc kernels, f32 the CUDA-core
# kernels at their 32-row tiling (phase 1 prints them all; the bf16 causal
# ones are phase 7c's and carry the wide rows' registers)
FLASH_WIDE = {
    (dt, form, causal): frag.format(c=int(causal))
    for causal in (True, False)
    for dt, form, frag in (
        ("bf16", "stats", "flash_fwd_wide_tc_kernelILb{c}ELb1EE"),
        ("bf16", "normalized", "flash_fwd_wide_tc_kernelILb{c}ELb0EE"),
        ("bf16", "dq", "flash_dq_wide_tc_kernelILb{c}EE"),
        ("bf16", "dkv", "flash_dkv_wide_tc_kernelILb{c}EE"),
        ("f32", "stats", "flash_fwd_kernelILi32ELi256ELb{c}ELb1EE"),
        ("f32", "normalized", "flash_fwd_kernelILi32ELi256ELb{c}ELb0EE"),
        ("f32", "dq", "flash_dq_kernelILi32ELi256ELb{c}EE"),
        ("f32", "dkv", "flash_dkv_kernelILi32ELi256ELb{c}EE"))}
FLASH_WIDE_USAGE: dict = {}
# the wide bf16 kernels' designs, as the phase 2c rows print them
_FWD_WIDE_DESIGN = ("warp-specialized: a TMA producer warpgroup loads Q "
                    "and streams 80-key K/V tiles through a 2-stage ring, K "
                    "and V on their own mbarriers; two consumer warpgroups "
                    "of 64 rows (a 128-row q tile, q2 made in place) take "
                    "turns on named barriers, one's softmax under the "
                    "other's products; setmaxnreg 56/224")
FLASH_WIDE_DESIGN = {
    "stats": _FWD_WIDE_DESIGN,
    "normalized": _FWD_WIDE_DESIGN,
    "dq": "warp-specialized: a TMA producer warpgroup streams 32-key K/V "
          "tiles through a 3-stage ring; two consumer warpgroups of 64 "
          "rows (a 128-row q tile, Q and dO resident); setmaxnreg 56/224",
    "dkv": "warp-specialized: a TMA producer warpgroup streams 32-row "
           "Q/dO tiles through a 4-stage ring and makes q2 in place; the "
           "consumers split by product (s^T, p, dv | dp^T, ds, dk; p "
           "passed through shared memory), each tile's scores issued "
           "behind the last tile's dv / dk products; the overlap is across "
           "the two consumers; setmaxnreg 56/224"}
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
    for frags, into in ((FLASH_TC, FLASH_USAGE),
                        (FLASH_WIDE, FLASH_WIDE_USAGE), (MLP_TC, MLP_USAGE),
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
    serial = wgmma_serialized(_build.last_build.get("log") or "")
    if serial:
        raise RuntimeError(f"the compiler serialized the wgmma products of "
                           f"{serial}")
    log("[build]   no kernel's wgmma products serialized")


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


# the wide-head cases (128 < D <= 256, the wide instantiations), each
# against the plain versions within FLASH_TOL of its dtype: bf16 at the
# path's length (phase 7c's heads, batch 1) and at a ragged S, a D padded
# from 192, and f32 at a causal D 256 and a ragged S with D 200
FLASH_WIDE_CASES = ((1, 8192, 4, 256, True, torch.bfloat16),
                    (2, 1000, 4, 256, True, torch.bfloat16),
                    (1, 512, 2, 192, False, torch.bfloat16),
                    (1, 1024, 2, 256, True, torch.float32),
                    (1, 300, 2, 200, True, torch.float32))
# the attention shape of the transformer trainer's path (phase 7) and of
# the same model at 4 heads of 256 (phase 7c): the flash kernels are
# timed at both
FLASH_PATH_SHAPES = ((8, 8192, 8, 128), (8, 8192, 4, 256))


def _flash_inputs(b, s, h, d, seed, dtype=torch.bfloat16):
    g = _gen(seed)
    return [torch.randn(b, s, h, d, generator=g, device="cuda").to(dtype)
            for _ in range(4)]


def _flash_timed(card: str, shape, seeds, errs: dict) -> list:
    """B5's two forms, B6 and B7 at the path's bf16 causal ``shape``:
    the plain versions timed at batch 1 (the full batch's plain scores
    would not fit), the kernels at the full batch, each batch element of
    the timed launches' outputs held against the plain version on that
    element's inputs (``errs`` takes the largest errors), SDPA's forward
    and backward and the bound beside them; the report's rows."""
    import torch.nn.functional as F

    from distributed_tensorflow_example_tpu_torch.ops import (
        flash_attention as fa)

    cdt = torch.bfloat16
    tol = FLASH_TOL[cdt]
    b, s, h, d = shape
    wide = d > 128
    q1, k1, v1, do1 = _flash_inputs(1, s, h, d, seeds[0])
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

    q, k, v, do = _flash_inputs(*shape, seeds[1])
    acc, m, l = fa.flash_forward(q, k, v, True, stats=True)
    o = (acc / l[..., None]).to(cdt)
    dlt = torch.sum(do.float() * o.float(), dim=-1)
    # the path's own launches, each batch element held against the plain
    # version on that element's inputs (batch-1 memory); the backward
    # kernels take the stats kernel's m and l and its dlt
    o_n = fa.flash_forward(q, k, v, True)
    dq = fa.flash_dq(q, k, v, do, m, l, dlt, True)
    dk, dv = fa.flash_dkv(q, k, v, do, m, l, dlt, True)
    torch.cuda.synchronize()
    for i in range(b):
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
                   plain_shape=[1, s, h, d], library_ms=lib,
                   library_call=("scaled_dot_product_attention(is_causal="
                                 "True) " + ("forward" if name ==
                                             "flash_forward" else
                                             "backward (dq, dk and dv "
                                             "together)")),
                   bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops,
                   tflops=flops / kern[form] / 1e9,
                   x_library=kern[form] / lib,
                   max_abs_err=errs[name][0], rel_err=errs[name][1])
        use = (FLASH_WIDE_USAGE.get(("bf16", form, True)) if wide
               else FLASH_USAGE.get(form))
        if use is not None:
            row.update(design=(FLASH_WIDE_DESIGN[form] if wide
                               else "wgmma+cp.async"),
                       regs=use["regs"],
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
    return rows


def check_flash(card: str) -> list:
    """B5 (both forms), B6 and B7 against their plain versions, at
    D 128 and below and at the wide head dims, then timed at the two path
    shapes (FLASH_PATH_SHAPES)."""
    from distributed_tensorflow_example_tpu_torch.ops import (
        flash_attention as fa)

    bf16 = torch.bfloat16
    # per kernel: (largest absolute error, largest error of scale)
    errs = {"flash_forward": (0.0, 0.0), "flash_dq": (0.0, 0.0),
            "flash_dkv": (0.0, 0.0)}
    # the transformer path's length at batch 1, the MoE path's whole
    # batch (about 1 GB of f32 scores per plain tensor), two ragged
    # shapes, then the wide-head cases
    cases = [(b, s, h, d, causal, bf16, 11000 + s)
             for b, s, h, d, causal in ((1, 8192, 8, 128, True),
                                        (32, 1024, 8, 128, True),
                                        (2, 1000, 8, 128, True),
                                        (1, 300, 8, 64, False))]
    cases += [(*c, 13000 + c[1] + c[3]) for c in FLASH_WIDE_CASES]
    for b, s, h, d, causal, cdt, seed in cases:
        tol = FLASH_TOL[cdt]
        dname = "bf16" if cdt == bf16 else "f32"
        q, k, v, do = _flash_inputs(b, s, h, d, seed, cdt)
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
        log(f"[kernel] flash [{b}, {s}, {h}, {d}] {dname} causal={causal}: "
            f"forward {fwd[1]:.3g}, dq {e_dq[1]:.3g}, dk/dv {e_dkv[1]:.3g} "
            f"of scale (tol {tol}); max abs {fwd[0]:.3g}, {e_dq[0]:.3g}, "
            f"{e_dkv[0]:.3g}")
        for name, e in (("flash_forward", fwd), ("flash_dq", e_dq),
                        ("flash_dkv", e_dkv)):
            if not e[1] <= tol:
                raise AssertionError(f"{name} [{b}, {s}, {h}, {d}] {dname} "
                                     f"causal={causal}: {e[1]} of scale > "
                                     f"{tol}")
            errs[name] = (max(errs[name][0], e[0]),
                          max(errs[name][1], e[1]))
        del q, k, v, do, o_r, acc_r, want, acc, dq, dk, dv
        torch.cuda.empty_cache()

    rows = []
    for shape, seeds in zip(FLASH_PATH_SHAPES, ((12001, 12002),
                                                (12003, 12004))):
        rows += _flash_timed(card, shape, seeds, errs)
    return [(name, [r for r in rows if r["kernel"] == name])
            for name in ("flash_forward", "flash_dq", "flash_dkv")]


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

    split, call_us = launch_us(fused.layer_norm_backward, _ln_bwd_inputs())
    row["launches_us"] = split
    each = ("not measured" if split is None else ", ".join(
        f"{k} {v:.2f} us" for k, v in split.items()))
    log(f"[kernel] layer_norm_backward rows={LN_BWD_SHAPE[0]} d="
        f"{LN_BWD_SHAPE[1]} f32, a call {call_us:.2f} us (CUDA events), "
        f"each launch: {each} on {card} (the column sum's time starts at "
        f"its early launch)")


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


# the files of a run directory that dtx-obs reads (phase 9)
OBS_STREAMS = re.compile(r"(metrics|spans)\.\d+\.jsonl(\.\d+)?$|"
                         r"heartbeat\.\d+$|restarts\.jsonl$|"
                         r"workload\.json$|flight/\w+\.json$")


def _keep(keep, name: str, src: str) -> None:
    """Copy the streams dtx-obs reads (``OBS_STREAMS``) of the run
    directories under ``src`` to ``keep/name`` for phase 9 (nothing when
    ``keep`` is None).  Checkpoints and traces stay behind."""
    if keep is None:
        return
    for root, _dirs, files in os.walk(src):
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), src)
            if OBS_STREAMS.search(rel.replace(os.sep, "/")):
                dst = os.path.join(keep, name, rel)
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                shutil.copy2(os.path.join(root, f), dst)


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
TRACE_SLO = "ttft_p99_ms<=250,error_rate<=0.01"
TRACE_FLAGS = ["--trace_spans", f"--slo={TRACE_SLO}"]
# a waterfall's segments must tile at least this share of its wall
WATERFALL_MIN_FRAC = 0.99


def phase_http_traced(flags=FULL_WIDTH_FLAGS, keep=None) -> dict:
    """The CLI's server with ``--trace_spans --slo=...`` and logs in a
    temporary directory: one POST /generate, then /trace?rid=0 (the
    record holds submit, admit, prefill, first_token and retire), /slo
    (the parsed specs' document) and /explain?rid=0 (its segments tile
    at least WATERFALL_MIN_FRAC of submit->terminal); every span row in
    the file passes the port's validator.  The streams are kept under
    ``keep/traced`` (``_keep``)."""
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
        _keep(keep, "traced", logs)
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


def phase_status(flags=FULL_WIDTH_FLAGS, keep=None) -> dict:
    """One engine on the status server (phase 4d): the phase 4b flags
    plus ``--engine_retries=1``, logs in a temporary directory seeded
    with one metrics stream (``_metrics_fixture``).  After one POST
    /generate: /status carries the engine's stats under ``serving``,
    /metrics at least one dtx_generate_*, dtx_slo_* and dtx_waterfall_*
    gauge, /report a run report the port's schema accepts (its restart
    summary included), /fleet a one-source fleet report that is
    exactly-once; the restart narrator is armed.  The streams are kept
    under ``keep/status``."""
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
        _keep(keep, "status", logs)
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


def phase_fleet(card: str, base: dict, flags=FULL_WIDTH_FLAGS,
                device: str = "cuda", keep=None) -> dict:
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
    serves' tokens/s and TTFT p50 (printed, not gated).  The fleet's
    streams are kept under ``keep/fleet`` (the one engine writes none)."""
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
            cli.settle(engines, 30.0)
            ticks = [e.stats()["decode_ticks_total"] for e in engines]
        finally:
            server.close()
            cli.stop_engines(engines, rt)
        rep = collector.fleet_report([os.path.join(logs, d) for d in
                                      ("replica0", "replica1", "router")])
        _keep(keep, "fleet", logs)
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


def phase_chaos(card: str, base: dict, device: str = "cuda",
                keep=None) -> dict:
    """Chaos on the card (phase 4f): three replicas at phase 3's model,
    replica 0 crashing at tick boundaries 1-4 under
    ``engine_retries=1``, behind a router with ``fleet_retries=2``,
    each with its span recorder and one restart narrator: phase 3's 8
    requests all end in a typed terminal, at least one failed over and
    kept its trace id, the port's fleet_report over the three replica
    dirs and the router's is exactly-once with clean failover chains,
    and restarts.jsonl holds the narrator's engine_restart rows, which
    the port's validator accepts.  The streams are kept under
    ``keep/chaos``."""
    from distributed_tensorflow_example_tpu_torch.obs import (
        collector, schema)
    from distributed_tensorflow_example_tpu_torch.obs.spans import (
        SpanRecorder)
    from distributed_tensorflow_example_tpu_torch.resilience import restart
    from distributed_tensorflow_example_tpu_torch.serving import cli, router
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
            cli.settle(engines, 30.0)
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
        _keep(keep, "chaos", run_dir)
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


# phase 4g: the workload's size and pace.  16 requests at 8 a second,
# half opening with one shared prefix, lengths scaled with seq_len, a
# relative deadline of 30 s; replayed at REPLAY_SPEED
REPLAY_N = 16
REPLAY_QPS = 8.0
REPLAY_DEADLINE_MS = 30000.0
REPLAY_SPEED = 2.0
# a replay must submit each request on its schedule: at most this late
REPLAY_MAX_LAG_S = 0.5


def _replay_cli(argv) -> dict:
    """``serving/cli.main(argv)`` in process: exit 0 and a stdout that is
    exactly one replay report JSON; returns the report."""
    from distributed_tensorflow_example_tpu_torch.serving import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    out = buf.getvalue()
    if rc != 0:
        raise AssertionError(f"replay: dtx-serve exited {rc}: {out[-2000:]}")
    report = json.loads(out)
    if report.get("kind") != "replay_report":
        raise AssertionError(f"replay: stdout is not a report: {out[:500]}")
    return report


def _tick_batches(run_dir: str) -> dict:
    """rid -> the batch sizes of the decode ticks it rode, from a span
    directory (one engine's, or a fleet's replicas)."""
    from distributed_tensorflow_example_tpu_torch.obs import spans

    out: dict = {}
    for root, _d, files in os.walk(run_dir):
        if any(f.startswith("spans.") for f in files):
            for row in spans.load_spans(root):
                if row.get("event") == "tick":
                    for rid in row.get("rids") or ():
                        out.setdefault(rid, []).append(row.get("batch"))
    return out


def phase_replay(card: str, flags=FULL_WIDTH_FLAGS,
                 speed: float = REPLAY_SPEED,
                 max_lag_s: float = REPLAY_MAX_LAG_S, keep=None) -> dict:
    """Workload replay (phase 4g) through ``serving/cli.main`` at phase
    3's model: a synthetic workload of REPLAY_N requests (shared-prefix
    groups, relative deadlines) written to a temporary file, replayed
    twice under ``--trace_spans`` at ``speed`` and once more with
    ``--replicas 2``.  Required: exit 0 with the report on stdout, no
    wedged or failed terminal, the same terminal multiset in all three;
    B2, B3 and B8 launched (counters zeroed just before the phase, on
    the card); every span row names the workload (``replay_of``) and the
    first replay's stream re-captures to the input's schedule: the same
    prompt lengths, output lengths and fingerprints in arrival order
    (its arrivals are the wall clock's, so the re-captured id differs
    from the input's; the id itself round-trips through ``replay_sim``,
    checked here too).  Printed: each replay's tokens/s, the
    determinism_frac of the two one-engine replays and, for each
    mismatching rid, the batch sizes of the ticks it rode in each.  The
    submits must reach the engine at most ``max_lag_s`` behind their
    schedule (read off the first replay's re-capture).  The workload and
    the streams are kept under ``keep/replay``."""
    from distributed_tensorflow_example_tpu_torch.obs import (
        schema, spans, workload)
    from distributed_tensorflow_example_tpu_torch.ops import fused
    from distributed_tensorflow_example_tpu_torch.serving import replay

    device = "cpu" if "--device=cpu" in flags else "cuda"
    seq = next(int(f.split("=")[1]) for f in flags
               if f.startswith("--input_size="))
    vocab = next((int(f.split("=")[1]) for f in flags
                  if f.startswith("--vocab_size=")), 256)
    doc = workload.synthetic_workload(
        REPLAY_N, seed=0, qps=REPLAY_QPS, mean_prompt=max(2, seq // 24),
        mean_new=max(2, seq // 32), vocab_size=vocab,
        deadline_ms=REPLAY_DEADLINE_MS)
    wid = doc["workload_id"]
    reports, dirs = [], []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "workload.json")
        workload.write_workload(doc, path)
        _sync(device)
        fused.reset_launch_counts()
        for i, extra in enumerate(([], [], ["--replicas=2"])):
            logs = os.path.join(tmp, f"replay{i}")
            reports.append(_replay_cli(flags + extra + [
                f"--replay={path}", f"--replay_speed={speed:g}",
                "--trace_spans", f"--logs_path={logs}"]))
            dirs.append(logs)
        _sync(device)
        counts = fused.launch_counts()
        rows = [r for root, _d, files in os.walk(tmp)
                if any(f.startswith("spans.") for f in files)
                for r in spans.load_spans(root)]
        errs = [e for r in rows for e in schema.validate_span_row(r)]
        cap = workload.capture(dirs[0])
        ticks = [_tick_batches(d) for d in dirs[:2]]
        sim_dir = os.path.join(tmp, "sim")
        rec = replay.replay_recorder(sim_dir, wid)
        replay.replay_sim(doc, recorder=rec)
        rec.close()
        sim_cap = workload.capture(sim_dir)
        _keep(keep, "replay", tmp)
    _require(counts, SERVE_WRAPPERS, (), "replay", device)
    for rep in reports:
        if rep["workload_id"] != wid or rep["n_requests"] != REPLAY_N:
            raise AssertionError(f"replay report of another workload: "
                                 f"{rep['workload_id']}")
        bad = {t: n for t, n in rep["terminals"].items()
               if t in ("wedged", "failed")}
        if bad:
            raise AssertionError(f"replay: terminals {rep['terminals']}")
    if len({json.dumps(r["terminals"], sort_keys=True)
            for r in reports}) != 1:
        raise AssertionError(f"replay: terminal multisets differ: "
                             f"{[r['terminals'] for r in reports]}")
    if errs or not rows or {r.get("replay_of") for r in rows} != {wid}:
        raise AssertionError(f"replay spans: {errs[:5]} replay_of "
                             f"{ {r.get('replay_of') for r in rows} }")
    key = ("prompt_len", "max_new_tokens", "fingerprint")
    if [[r[k] for k in key] for r in cap["requests"]] != \
            [[r[k] for k in key] for r in doc["requests"]]:
        raise AssertionError("replay: the first replay's stream does not "
                             "re-capture to the input's schedule")
    if sim_cap["workload_id"] != wid:
        raise AssertionError(f"replay_sim re-captured {sim_cap['workload_id']}"
                             f", not {wid}")
    # how late the engine took each submit against the schedule
    lag = max(r["arrival_s"] - w["arrival_s"] / speed
              for r, w in zip(cap["requests"], doc["requests"]))
    if not lag <= max_lag_s:
        raise AssertionError(f"replay: a submit reached the engine {lag} s "
                             f"behind its schedule > {max_lag_s}")
    ident = replay.identity(reports[0], reports[1])
    fleet_ident = replay.identity(reports[0], reports[2])
    tps = [r["tokens_total"] / r["wall_s"] for r in reports]
    log(f"[replay] {wid}: {REPLAY_N} requests over {doc['duration_s']:g} s "
        f"recorded at x{speed:g}: terminals {reports[0]['terminals']}; "
        f"one engine {tps[0]:.1f} and {tps[1]:.1f} tokens/s, 2 replicas "
        f"{tps[2]:.1f} tokens/s; determinism_frac {ident['determinism_frac']}"
        f" (one engine twice), {fleet_ident['determinism_frac']} (fleet vs "
        f"one engine); launches {counts}; {len(rows)} span rows valid, all "
        f"replay_of {wid}; re-capture of replay 1: schedule equal, id "
        f"{cap['workload_id']} (submits at most {lag:.4f} s behind the "
        f"schedule); replay_sim re-capture id {sim_cap['workload_id']} "
        f"on {card}")
    for m in ident["mismatches"]:
        rid = m["rid"]
        log(f"[replay] rid {rid} differs: {m['a']} vs {m['b']}; decode "
            f"tick batch sizes {ticks[0].get(rid)} vs {ticks[1].get(rid)}")
    return dict(counts=counts, tps=tps,
                qps=[r["terminals"].get("result", 0) / r["wall_s"]
                     for r in reports],
                determinism_frac=ident["determinism_frac"],
                fleet_frac=fleet_ident["determinism_frac"],
                mismatches=[m["rid"] for m in ident["mismatches"]],
                recaptured=cap["workload_id"], lag_s=lag)


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


# phase 5b: the mxu_wide_pallas widths (WIDE_TRAIN) as a command line,
# one epoch of 8 steps on the host path with a snapshot every 2 steps
RESILIENCE_FLAGS = [
    "--hidden_sizes=4096,4096", "--activation=relu",
    "--compute_dtype=bfloat16", "--batch_size=8192", "--pallas",
    "--dataset=synthetic", "--synthetic_train_size=65536",
    "--synthetic_test_size=10000", "--training_epochs=1", "--no_summaries",
    "--frequency=1", "--seed=1", "--ckpt_every=2"]
# the SIGTERM'd trainer: the port's main with every step from the 4th on
# followed by a pause, so that the signal sent once the step-4 snapshot
# is valid reaches the run before its epoch ends (the pause only waits:
# the steps, their data and their numbers are the trainer's own)
PACED_MAIN = (
    "import sys, time\n"
    "from distributed_tensorflow_example_tpu_torch import main\n"
    "from distributed_tensorflow_example_tpu_torch.parallel import step\n"
    "PACE, make, n = float(sys.argv[1]), step.make_sync_step_body, [0]\n"
    "def paced(*a, **k):\n"
    "    body = make(*a, **k)\n"
    "    def run(*b):\n"
    "        out = body(*b)\n"
    "        n[0] += 1\n"
    "        if n[0] >= 4:\n"
    "            time.sleep(PACE)\n"
    "        return out\n"
    "    return run\n"
    "step.make_sync_step_body = paced\n"
    "sys.exit(main.main(sys.argv[2:]))\n")


def _run_trainer(argv, what: str, device: str, fast: bool = False,
                 wrappers=TRAIN_WRAPPERS) -> tuple:
    """``loop.run`` of a trainer command line in process, its launch
    counts zeroed just before and read just after (each of ``wrappers``,
    B1 by default, must launch on the card), on the host path (or, with
    ``fast``, the fast path); returns ``(result, stdout, counts)``."""
    from distributed_tensorflow_example_tpu_torch.config import (
        parse_train_config)
    from distributed_tensorflow_example_tpu_torch.ops import fused
    from distributed_tensorflow_example_tpu_torch.train import loop

    cfg = parse_train_config(argv)
    _sync(device)
    fused.reset_launch_counts()
    res, out = _run_captured(loop.run, cfg)
    _sync(device)
    counts = fused.launch_counts()
    _require(counts, wrappers, (), what, device)
    if res["fast_loop"] != fast:
        raise AssertionError(f"{what}: took fast_loop={res['fast_loop']}")
    return res, out, counts


def _newest(ckpt_dir: str) -> tuple:
    """``({key: CPU tensor}, manifest)`` of the newest valid snapshot."""
    from distributed_tensorflow_example_tpu_torch.resilience import manifest

    found = manifest.newest_valid_snapshot(ckpt_dir)
    if found is None:
        raise AssertionError(f"no valid snapshot under {ckpt_dir}")
    return manifest.restore_arrays(ckpt_dir, found[0])[0], found[0]


def _differing(a: dict, b: dict) -> list:
    return sorted(k for k in set(a) | set(b)
                  if k not in a or k not in b or a[k].dtype != b[k].dtype
                  or not torch.equal(a[k], b[k]))


def phase_resilience(card: str, flags=RESILIENCE_FLAGS, pace: float = 1.5,
                     device: str = "cuda") -> dict:
    """The trainer's resilience store (phase 5b) at the mxu_wide_pallas
    widths, one epoch of 8 steps under ``--ckpt_every=2`` on the host
    path: (1) one uninterrupted run, twice — the second also saving a
    classic ``--sharded_checkpoints --async_checkpoints`` checkpoint
    every 4 steps — their final snapshots bitwise equal, and the classic
    ``ckpt-8.shards`` restored bitwise equal to its run's final
    snapshot; (2) the trainer in a subprocess (``PACED_MAIN``) sent
    SIGTERM once its step-4 snapshot is valid: exit 143 through
    ``Preempted``, ``restarts.jsonl`` holding a ``preempt`` row; (3) a
    ``--resume=auto`` relaunch whose final snapshot is bitwise the
    uninterrupted run's.  B1 launches in every in-process run (counters
    zeroed just before each).  Printed: the loop's stall of each
    periodic snapshot (``ckpt_stall_ms``), the writer's mean write ms,
    the bytes of one snapshot and of the run's writes."""
    from distributed_tensorflow_example_tpu_torch.config import (
        parse_train_config)
    from distributed_tensorflow_example_tpu_torch.resilience.restart import (
        read_restarts)
    from distributed_tensorflow_example_tpu_torch.train import loop
    from distributed_tensorflow_example_tpu_torch.train.optim import (
        make_optimizer)
    from distributed_tensorflow_example_tpu_torch.train.state import (
        create_train_state)
    from distributed_tensorflow_example_tpu_torch.utils import checkpoint

    flags = list(flags) + ([f"--device={device}"] if device == "cpu"
                           else [])
    with tempfile.TemporaryDirectory() as tmp:
        def run_flags(name):
            return flags + [f"--checkpoint_dir={tmp}/{name}",
                            f"--logs_path={tmp}/{name}_logs"]

        ref, _out, counts = _run_trainer(run_flags("a"), "resilience",
                                         device)
        again, _out, _c = _run_trainer(
            run_flags("b") + ["--checkpoint_every=4",
                              "--sharded_checkpoints",
                              "--async_checkpoints"],
            "resilience (sharded, async)", device)
        want, wman = _newest(f"{tmp}/a")
        twice, _m = _newest(f"{tmp}/b")
        diff = _differing(want, twice)
        if diff or wman["step"] != ref["steps"]:
            raise AssertionError(f"resilience: two uninterrupted runs "
                                 f"differ in {diff} (final step "
                                 f"{wman['step']})")
        cfg = parse_train_config(run_flags("b"))
        spec = loop.make_spec(cfg)
        template = create_train_state(
            spec, make_optimizer(cfg, ref["steps"]), device="cpu")
        shards = checkpoint.latest_checkpoint(f"{tmp}/b")
        if not shards.endswith(f"ckpt-{ref['steps']:08d}.shards"):
            raise AssertionError(f"resilience: classic checkpoint {shards}")
        classic, step, _e = checkpoint.restore_checkpoint(shards, template)
        diff = _differing(checkpoint.flatten_state(classic), twice)
        if diff or step != ref["steps"]:
            raise AssertionError(f"resilience: the sharded async checkpoint "
                                 f"differs from the snapshot in {diff}")

        # the preempted trainer
        argv = run_flags("c")
        env = dict(os.environ,
                   PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
        t0 = time.monotonic()
        proc = subprocess.Popen(
            [sys.executable, "-c", PACED_MAIN, str(pace)] + argv,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        try:
            deadline = time.monotonic() + 300
            signalled = None
            while time.monotonic() < deadline and proc.poll() is None:
                found = _valid_step(f"{tmp}/c")
                if found is not None and found >= 4:
                    proc.send_signal(signal.SIGTERM)
                    signalled = found
                    break
                time.sleep(0.02)
            out, _ = proc.communicate(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        sub_s = time.monotonic() - t0
        for line in out.splitlines():
            log(f"  | {line}")
        preempted = [ln for ln in out.splitlines()
                     if ln.startswith("Preempted")]
        rows = [r["event"] for r in read_restarts(f"{tmp}/c_logs")]
        if proc.returncode != 143 or not preempted or "preempt" not in rows:
            raise AssertionError(
                f"resilience: the SIGTERM'd trainer exited "
                f"{proc.returncode} (signalled after the step-{signalled} "
                f"snapshot), Preempted lines {preempted}, restarts {rows}")
        stopped = _newest(f"{tmp}/c")[1]

        resumed, out, rcounts = _run_trainer(argv + ["--resume=auto"],
                                             "resilience --resume=auto",
                                             device)
        got, gman = _newest(f"{tmp}/c")
        diff = _differing(got, want)
        if diff or gman["step"] != wman["step"]:
            raise AssertionError(f"resilience: the resumed run differs from "
                                 f"the uninterrupted one in {diff}")
        rows = [r["event"] for r in read_restarts(f"{tmp}/c_logs")]
    stats = ref["checkpoint_stats"]
    snap_bytes = sum(t.numel() * t.element_size() for t in want.values())
    stall = stats["ckpt_stall_ms"]
    log(f"[resilience] {ref['steps']} steps of {' '.join(flags)} on the "
        f"host path, twice: final snapshots bitwise equal; the sharded async "
        f"classic "
        f"checkpoint restored bitwise; the trainer SIGTERM'd after its "
        f"step-{signalled} snapshot exited 143 with its final snapshot at "
        f"step {stopped['step']} (+{stopped['data_state']['batches_done']} "
        f"in-epoch batches; subprocess {sub_s:.1f} s, pace {pace:g} s a step "
        f"from step 4); --resume=auto to step {gman['step']}: bitwise the "
        f"uninterrupted run; restarts.jsonl {rows}; launches {counts} "
        f"(resumed: {rcounts})")
    log(f"[resilience] ckpt_stall_ms {stall} (median "
        f"{statistics.median(stall):.4f}), writer: {stats['written']} "
        f"written, {stats['coalesced']} coalesced, mean write "
        f"{stats['ckpt_write_ms_mean']:.1f} ms, {stats['bytes_written']} "
        f"bytes written; one snapshot {snap_bytes} bytes on {card}")
    return dict(counts=counts, resumed_counts=rcounts, stall_ms=stall,
                write_ms=stats["ckpt_write_ms_mean"], snap_bytes=snap_bytes,
                bytes_written=stats["bytes_written"],
                stopped=stopped["step"])


def _valid_step(ckpt_dir: str):
    """The step of the newest valid snapshot under ``ckpt_dir``, or
    None."""
    from distributed_tensorflow_example_tpu_torch.resilience import manifest

    found = manifest.newest_valid_snapshot(ckpt_dir)
    return None if found is None else found[0]["step"]


# phase 5c: the mxu_wide_pallas widths (WIDE_TRAIN) as a command line, one
# epoch of 8 steps on the default fast path (the step a CUDA graph)
MONITOR_FLAGS = [f for f in RESILIENCE_FLAGS if f != "--ckpt_every=2"]
# every monitoring flag the fast path takes
MONITOR_ON = ["--metrics", "--log_every=4", "--flight", "--on_anomaly=skip"]
# the blow-up injection (the JAX package's tests/test_forensics.py): the
# first step's update is ~1e30 x the gradient, and the next step's
# saturated softmax under the naive cross entropy gives inf/inf
BLOWUP_FLAGS = ["--learning_rate=1e30", "--naive_ce"]
# phase 5c (e): the transformer_wide_long run under --metrics with a
# torch.profiler window over steps 1 and 2
TFM_PROFILE_FLAGS = ["--metrics", "--profile_steps=1:2"]


def _latest_ckpt(ckpt_dir: str) -> str:
    from distributed_tensorflow_example_tpu_torch.utils import checkpoint

    return checkpoint.latest_checkpoint(ckpt_dir)


def _npz_params(ckpt_dir: str) -> dict:
    """The arrays of the newest classic ``.npz`` checkpoint."""
    with np.load(_latest_ckpt(ckpt_dir)) as z:
        return {k: z[k] for k in z.files}


@contextlib.contextmanager
def _held_at_run_end(seen: threading.Event, timeout: float = 30.0):
    """Hold the trainer at its ``run_end`` metrics event until ``seen``
    is set (at most ``timeout`` s): the fast path writes its window rows
    at the end of the run and the status server closes with it, so a
    poller gets this long to read them.  The pause only waits."""
    from distributed_tensorflow_example_tpu_torch.obs import metrics

    real = metrics.MetricsLogger.log_event

    def log_event(self, event, **fields):
        if event == "run_end":
            seen.wait(timeout)
        return real(self, event, **fields)

    metrics.MetricsLogger.log_event = log_event
    try:
        yield
    finally:
        metrics.MetricsLogger.log_event = real


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _epoch_ab(cfgs: dict, rounds: int) -> dict:
    """Warm ms a step of each config's device-resident epoch (the MLP's
    step a CUDA graph), one runner and state each from the same seed,
    timed with CUDA events over ``rounds`` interleaved rounds (the
    order flips every round)."""
    from distributed_tensorflow_example_tpu_torch.data import mnist
    from distributed_tensorflow_example_tpu_torch.parallel import epoch
    from distributed_tensorflow_example_tpu_torch.train import loop, optim
    from distributed_tensorflow_example_tpu_torch.train.state import (
        create_train_state)
    from distributed_tensorflow_example_tpu_torch.utils import prng

    first = next(iter(cfgs.values()))
    data = mnist.synthesize_split(first.synthetic_train_size, seed=1)
    img, lbl, spe = epoch.shard_dataset(data.images, data.labels,
                                        first.batch_size, "cuda")
    key = prng.PRNGKey(first.seed + epoch.SHUFFLE_SALT)
    arms = {}
    for name, cfg in cfgs.items():
        spec = loop.make_spec(cfg)
        opt = optim.make_optimizer(cfg, (2 * rounds + 1) * spe)
        state = create_train_state(spec, opt, seed=cfg.seed, device="cuda")
        run = epoch.build_epoch_runner(cfg, spec, opt, spe, "cuda")
        state, _c, _a = run(state, img, lbl, key, 0)
        arms[name] = [run, state, []]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    names = list(arms)
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            run, state, times = arms[name]
            ev[0].record()
            state, _c, _a = run(state, img, lbl, key, r + 1)
            ev[1].record()
            torch.cuda.synchronize()
            times.append(ev[0].elapsed_time(ev[1]) / spe)
            arms[name][1] = state
    return {name: arm[2] for name, arm in arms.items()}


def phase_monitoring(card: str, graph_counts: dict, flags=MONITOR_FLAGS,
                     tfm_flags=WIDE_LONG_FLAGS, device: str = "cuda",
                     rounds: int = 3, keep=None) -> dict:
    """The trainer's monitoring (phase 5c) at the mxu_wide_pallas widths
    and on transformer_wide_long:

    (a) the default fast path (the step a CUDA graph) under ``--metrics
        --log_every=4 --flight --on_anomaly=skip --status_port``: the step
        still captured, B1's launches those of phase 5's graph run, every
        metrics row valid with ``0 < mfu <= 1``, a polling thread's
        ``/status`` and ``/metrics`` answers carrying the run's rows, the
        final params bitwise those of the same run without the flags;
    (b) the blow-up under ``--on_anomaly=skip`` on the graph path: the
        run completes, skipped steps >= 1, every param finite; the first
        flagged step printed;
    (c) the blow-up under ``--on_anomaly=halt``: the host path raises
        ``AnomalyError`` before the epoch ends, ``flight/0.json`` valid
        with reason ``anomaly_halt`` and blame on real leaves, and the
        chief's ``flight/report.json``;
    (d) what telemetry costs (printed, not gated): the graph epoch's warm
        ms a step with and without the skip mask over ``rounds``
        interleaved rounds, and the host path with and without
        ``--histograms``;
    (e) ``transformer_wide_long`` (``tfm_flags``) under ``--metrics
        --profile_steps=1:2``: the Chrome trace names the bf16 flash
        kernels (B5-B7), the trace scopes and the ``ln`` scope, and the
        graph dump beside it (``train_step.aten.txt``) holds a kernel
        line for each of B2-B7; the rows' MFU printed.

    On the CPU (a rehearsal at narrow widths, ``device="cpu"``) the
    counters stay 0, MFU is null and (d) and the kernel names are not
    checked.  The runs' streams are kept under ``keep/monitoring``."""
    import dataclasses

    from distributed_tensorflow_example_tpu_torch.config import (
        parse_train_config)
    from distributed_tensorflow_example_tpu_torch.obs import anomaly, flight
    from distributed_tensorflow_example_tpu_torch.obs import metrics, schema
    from distributed_tensorflow_example_tpu_torch.obs.buckets import (
        TRACE_SCOPES)
    from distributed_tensorflow_example_tpu_torch.ops import fused
    from distributed_tensorflow_example_tpu_torch.parallel import epoch, step
    from distributed_tensorflow_example_tpu_torch.train import loop

    on_card = device == "cuda"
    flags = list(flags) + ([] if on_card else ["--device=cpu"])
    out = {}
    t_phase = time.monotonic()
    with tempfile.TemporaryDirectory() as tmp:
        def argv(name, *extra):
            return flags + list(extra) + [
                f"--logs_path={tmp}/{name}", f"--checkpoint_dir={tmp}/{name}"]

        # (a) everything on, the status server polled while it runs
        t0 = time.monotonic()
        port = _free_port()
        seen_row, stop = threading.Event(), threading.Event()
        answers = {"status": [], "metrics": []}

        def poll():
            while not stop.is_set():
                try:
                    code, doc = _get_json(port, "/status")
                    code_m, text = _get_text(port, "/metrics")
                except OSError:
                    time.sleep(0.01)
                    continue
                if code == 200 and doc.get("last_window"):
                    answers["status"].append(doc)
                    if code_m == 200 and "dtx_" in text:
                        answers["metrics"].append(text)
                        seen_row.set()
                time.sleep(0.005)

        poller = threading.Thread(target=poll, daemon=True)
        poller.start()
        try:
            with _held_at_run_end(seen_row):
                res, _o, counts = _run_trainer(
                    argv("mon", *MONITOR_ON, f"--status_port={port}"),
                    "monitoring", device, fast=True)
        finally:
            stop.set()
            poller.join(timeout=30)
        mon_cfg = parse_train_config(argv("mon", *MONITOR_ON))
        if on_card and not epoch.captures(loop.make_spec(mon_cfg), "cuda"):
            raise AssertionError("monitoring: the step is not captured")
        if on_card and counts["mlp_forward"] != graph_counts["mlp_forward"]:
            raise AssertionError(f"monitoring: B1 launched "
                                 f"{counts['mlp_forward']} times, phase 5's "
                                 f"graph run {graph_counts['mlp_forward']}")
        mpath = f"{tmp}/mon/metrics.0.jsonl"
        errs = schema.validate_metrics_file(mpath)
        rows = metrics.read_metrics(mpath)
        windows = [r for r in rows if r["kind"] == "window"]
        compile_ev = [r for r in rows if r.get("event") == "compile"]
        if errs or not windows or not compile_ev:
            raise AssertionError(f"monitoring: metrics rows {rows}, "
                                 f"errors {errs}")
        for r in windows:
            mfu_ok = (r["mfu"] is not None and 0 < r["mfu"] <= 1
                      and r["tflops_per_sec"] is not None)
            if on_card and not mfu_ok:
                raise AssertionError(f"monitoring: window row {r}")
        if not answers["status"] or not answers["metrics"]:
            raise AssertionError("monitoring: the poller got no /status "
                                 "and /metrics answer with the run's rows")
        live = answers["status"][-1]["last_window"]
        if live["step"] != windows[-1]["step"]:
            raise AssertionError(f"monitoring: /status showed {live}")
        plain, _o, plain_counts = _run_trainer(argv("plain"), "plain",
                                               device, fast=True)
        got, want = _npz_params(f"{tmp}/mon"), _npz_params(f"{tmp}/plain")
        diff = sorted(k for k in want if not np.array_equal(got[k], want[k]))
        if diff or sorted(got) != sorted(want):
            raise AssertionError(f"monitoring: the monitored run's params "
                                 f"differ from the plain run's in {diff}")
        w = windows[-1]
        log(f"[monitoring] (a) graph path under {' '.join(MONITOR_ON)} "
            f"--status_port: {res['steps']} steps, compile (warm-up + "
            f"capture) {compile_ev[0]['dispatch_wall_s']} s, row: step time "
            f"{w['step_time_p50_ms']} ms, {w['examples_per_sec']} examples/s, "
            f"{w['tflops_per_sec']} TFLOP/s, mfu {w['mfu']}, device memory "
            f"{w['device_memory']}; {len(answers['status'])} live /status "
            f"answers; final params bitwise the plain run's; launches "
            f"{counts} (plain {plain_counts}; phase 5 {graph_counts}) "
            f"({time.monotonic() - t0:.1f} s)")
        out.update(counts=counts, mfu=w["mfu"], row=w,
                   compile_s=compile_ev[0]["dispatch_wall_s"])

        # (b) the blow-up skipped on the graph path
        t0 = time.monotonic()
        skip, _o, skip_counts = _run_trainer(
            argv("skip", *BLOWUP_FLAGS, "--on_anomaly=skip", "--metrics"),
            "skip", device, fast=True)
        params = _npz_params(f"{tmp}/skip")
        flagged = [r["step"] for r in metrics.read_metrics(
            f"{tmp}/skip/metrics.0.jsonl") if r.get("event") == "anomaly"]
        bad = sorted(k for k, v in params.items()
                     if v.dtype.kind == "f" and not np.isfinite(v).all())
        if skip["skipped_steps"] < 1 or bad or not flagged:
            raise AssertionError(f"skip: {skip['skipped_steps']} skipped, "
                                 f"anomalies at {flagged}, non-finite {bad}")
        log(f"[monitoring] (b) the blow-up ({' '.join(BLOWUP_FLAGS)}) under "
            f"--on_anomaly=skip on the graph path: first flagged step "
            f"{flagged[0]}, {skip['skipped_steps']} of {skip['steps']} steps "
            f"skipped, every param finite; launches {skip_counts} "
            f"({time.monotonic() - t0:.1f} s)")
        out.update(first_flagged=flagged[0],
                   skipped=skip["skipped_steps"], skip_counts=skip_counts)

        # (c) the blow-up halted: the host path, a flight dump
        t0 = time.monotonic()
        halt_cfg = parse_train_config(argv(
            "halt", *BLOWUP_FLAGS, "--on_anomaly=halt", "--metrics",
            "--log_every=4"))
        _sync(device)
        fused.reset_launch_counts()
        try:
            _run_captured(loop.run, halt_cfg)
        except anomaly.AnomalyError as e:
            halted = str(e)
        else:
            raise AssertionError("halt: the run did not raise AnomalyError")
        _sync(device)
        halt_counts = fused.launch_counts()
        _require(halt_counts, TRAIN_WRAPPERS, (), "halt", device)
        dump_path = f"{tmp}/halt/flight/0.json"
        doc = flight.read_flight(dump_path)
        errs = schema.validate_flight_file(dump_path)
        leaves = set(step.leaf_names(loop.make_spec(halt_cfg)))
        blamed = {k for a in doc["anomalies"] for k in a["blame"]}
        steps_per_epoch = halt_cfg.synthetic_train_size // \
            halt_cfg.batch_size
        if (errs or doc["reason"] != "anomaly_halt" or not blamed
                or not blamed <= leaves
                or doc["last_step"] >= steps_per_epoch
                or not os.path.exists(f"{tmp}/halt/flight/report.json")):
            raise AssertionError(f"halt: dump {doc['reason']} at step "
                                 f"{doc['last_step']}, blame {blamed}, "
                                 f"errors {errs}")
        log(f"[monitoring] (c) --on_anomaly=halt on the host path: "
            f"AnomalyError at step {doc['last_step']} of {steps_per_epoch} "
            f"({halted[:160]}); flight/0.json valid, blame {sorted(blamed)}, "
            f"report.json written; launches {halt_counts} "
            f"({time.monotonic() - t0:.1f} s)")
        out.update(halt_step=doc["last_step"], halt_counts=halt_counts)

        # (d) what the telemetry costs (printed, not gated)
        t0 = time.monotonic()
        if on_card:
            base = parse_train_config(MONITOR_FLAGS)
            ab = _epoch_ab({"plain": base, "skip": dataclasses.replace(
                base, on_anomaly="skip")}, rounds)
            host = {}
            for name, extra in (("plain", ()), ("histograms", (
                    "--histograms", "--log_every=4"))):
                h_argv = [f for f in argv(f"host_{name}", "--no_fast_loop",
                                          *extra) if f != "--no_summaries"]
                _r, h_out, _c = _run_trainer(h_argv, f"host {name}", device)
                host[name] = [float(m) for m in re.findall(
                    r"AvgTime: +(\d+\.\d+)ms", h_out)][1:]
            out.update(skip_ab=ab, host_hist=host)
            log(f"[monitoring] (d) graph epoch, warm ms a step, {rounds} "
                f"interleaved rounds: plain {[round(t, 4) for t in ab['plain']]}"
                f" (median {statistics.median(ab['plain']):.4f}), skip mask "
                f"{[round(t, 4) for t in ab['skip']]} (median "
                f"{statistics.median(ab['skip']):.4f}); host path steps 2-8 "
                f"ms: plain {host['plain']} (median "
                f"{statistics.median(host['plain']):.3f}), --histograms "
                f"{host['histograms']} (median "
                f"{statistics.median(host['histograms']):.3f}) on {card} "
                f"({time.monotonic() - t0:.1f} s)")

        # (e) the transformer under a profiler window
        t0 = time.monotonic()
        t_argv = list(tfm_flags) + TFM_PROFILE_FLAGS + [
            f"--logs_path={tmp}/tfm"] + ([] if on_card else ["--device=cpu"])
        tres, _o, tcounts = _run_trainer(t_argv, "transformer profile",
                                         device, fast=True,
                                         wrappers=TFM_WRAPPERS)
        traces = sorted(glob.glob(f"{tmp}/tfm/profile/trace.*.json"))
        if tres["profile_windows"] != 1 or len(traces) != 1:
            raise AssertionError(f"profile: {tres['profile_windows']} "
                                 f"windows, traces {traces}")
        with open(traces[0]) as f:
            events = json.load(f)["traceEvents"]
        names = {e.get("name", "") for e in events}
        device_names = {e.get("name", "") for e in events
                        if e.get("cat") == "kernel"}
        scopes = sorted(n for n in names if n in TRACE_SCOPES
                        or n.startswith("train#"))
        # the trace names kernels demangled ("void flash_dq_tc_kernel<
        # true>(...)"); FLASH_TC holds the mangled fragments
        kernels = sorted({k for k, frag in FLASH_TC.items()
                          for n in device_names
                          if frag in n or FLASH_TC_DEMANGLED[k] in n})
        want_kernels = {"stats", "dq", "dkv"} if on_card else set()
        if not scopes or not want_kernels <= set(kernels):
            flash = sorted(n[:120] for n in names if "flash" in n)[:10]
            raise AssertionError(f"profile: scopes {scopes}, flash kernels "
                                 f"{kernels} ({len(device_names)} kernel "
                                 f"names; flash names {flash}) in "
                                 f"{traces[0]}")
        # the graph dump of the run's first step beside the trace
        # (utils/graph.py): a kernel line for each of B2-B7's launches
        # on the card; the ln scopes inside the window
        dump = f"{tmp}/tfm/train_step.aten.txt"
        if not os.path.exists(dump):
            raise AssertionError(f"profile: no {dump}")
        with open(dump) as f:
            dump_lines = f.read().splitlines()
        dump_kernels = {}
        for ln in dump_lines:
            if ln.startswith("KERNEL "):
                name = ln[7:].split("(", 1)[0]
                dump_kernels[name] = dump_kernels.get(name, 0) + 1
        ln_ranges = sum(1 for e in events if e.get("name") == "ln")
        if not ln_ranges or (on_card
                             and sorted(dump_kernels) != sorted(TFM_WRAPPERS)):
            raise AssertionError(f"profile: {ln_ranges} ln ranges in the "
                                 f"trace, dump kernel lines {dump_kernels}")
        t_rows = [r for r in metrics.read_metrics(
            f"{tmp}/tfm/metrics.0.jsonl") if r["kind"] == "window"]
        log(f"[monitoring] (e) transformer_wide_long under "
            f"{' '.join(TFM_PROFILE_FLAGS)}: Chrome trace "
            f"{os.path.getsize(traces[0])} bytes, {len(events)} events, "
            f"{len(device_names)} kernel names, "
            f"scopes {scopes}, flash kernels {kernels}; rows: mfu "
            f"{[r['mfu'] for r in t_rows]}, TFLOP/s "
            f"{[r['tflops_per_sec'] for r in t_rows]}, step time "
            f"{[r['step_time_p50_ms'] for r in t_rows]} ms; launches "
            f"{tcounts}; {ln_ranges} ln ranges; graph dump "
            f"{len(dump_lines)} lines, kernel lines {dump_kernels} "
            f"({time.monotonic() - t0:.1f} s)")
        out.update(tfm_mfu=[r["mfu"] for r in t_rows], tfm_counts=tcounts,
                   tfm_row=t_rows[-1] if t_rows else None,
                   tfm_dump=dict(kernels=dump_kernels,
                                 lines=len(dump_lines), ln_ranges=ln_ranges))
        _keep(keep, "monitoring", tmp)
    log(f"[monitoring] phase 5c took {time.monotonic() - t_phase:.1f} s")
    return out


# phase 5d: data parallelism in a one-rank NCCL group, which
# cluster.bootstrap sets up from --coordinator_address with
# --num_processes=1: WIDE_TRAIN under Adam, 8 steps, each strategy
DP_BASE = dict(WIDE_TRAIN, optimizer="adam")
# name: the strategy's flags (ZeRO-1 takes the host path, as in JAX)
DP_RUNS = {
    "plain": {},
    "plain_host": dict(fast_loop=False),
    "zero": dict(zero_opt=True, fast_loop=False),
    "fsdp": dict(fsdp=True),
    "fsdp_host": dict(fsdp=True, fast_loop=False),
    "sync_period": dict(sync_period=2),
    # phase 7e (e): --debug_nans under --fsdp (the host path)
    "fsdp_nans": dict(fsdp=True, fast_loop=False, debug_nans=True),
}
# the plain run each is held to: the same path, so the same data order
DP_REF = {"plain": "plain", "sync_period": "plain", "fsdp": "plain",
          "plain_host": "plain_host", "zero": "plain_host",
          "fsdp_host": "plain_host", "fsdp_nans": "fsdp_host"}
# final params against the plain run's: --sync_period=2 bitwise (at one
# rank a replica's mean is the replica, and the local step is the sync
# step without its identity all-reduce and /1); ZeRO-1 and FSDP bitwise
# or within this fraction of each leaf's scale (their Adam runs on flat
# [chunk] views of the same elements, and the gathered params feed the
# same kernels: no reason to differ but an elementwise kernel's
# vectorization over another shape)
DP_PARAMS_RTOL = 1e-6
DP_COLLECTIVES = ("all_reduce", "all_gather", "reduce_scatter")


def _collective_kind(name: str):
    """``(family, collective)`` of a profiler op that records one: the
    dispatcher's ops ("c10d::allreduce_", "c10d::_allgather_base_",
    "c10d::_reduce_scatter_base_") or the backend's ranges
    ("nccl:all_reduce", "gloo:all_gather", ...); else None."""
    low = name.lower().replace("allreduce", "all_reduce").replace(
        "allgather", "all_gather")
    family = low.split(":", 1)[0]
    if family not in ("c10d", "nccl", "gloo"):
        return None
    kind = next((k for k in DP_COLLECTIVES if k in low), None)
    return (family, kind) if kind else None


def _dp_time(device: str, fn, n: int) -> float:
    """The median ms of ``n`` calls of ``fn`` after one, each between
    two CUDA events on the card (the host clock in the CPU rehearsal):
    an eager host step is host-bound, and one slow call should not move
    the reading."""
    fn()
    _sync(device)
    times = []
    for _ in range(n):
        if device == "cuda":
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            fn()
            ev[1].record()
            torch.cuda.synchronize()
            times.append(ev[0].elapsed_time(ev[1]))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _dp_collectives_ms(device: str, fn) -> dict:
    """``{collective: device ms}`` of one call of ``fn`` in a
    ``torch.profiler`` window (each collective op's device time,
    kernels and copies it launched included; host ms on the CPU)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device == "cuda" else [])
    _sync(device)
    with profile(activities=acts) as prof:
        fn()
        _sync(device)
    by_family = {}
    for e in prof.key_averages():
        found = _collective_kind(e.key)
        if found is None:
            continue
        family, kind = found
        t = (getattr(e, "device_time_total", None)
             if device == "cuda" else e.cpu_time_total)
        out = by_family.setdefault(family, {})
        out[kind] = out.get(kind, 0.0) + (t or 0.0) / 1e3
    # the dispatcher's ops where the profiler records them (they hold
    # the backend's ranges: one family, or the times count twice)
    return by_family.get("c10d") or next(iter(by_family.values()), {})


def dp_child(args: dict) -> dict:
    """Phase 5d in its own process (the NCCL group lives and dies with
    it): ``cluster.bootstrap`` sets up the one-rank group from the
    flags; in it each strategy's full run through ``loop.run`` (given
    the same flags, it finds the group up and leaves it so), the launch
    counts zeroed just before and read just after; then each strategy's
    step timed and its collectives profiled."""
    import dataclasses

    from distributed_tensorflow_example_tpu_torch import cluster
    from distributed_tensorflow_example_tpu_torch.config import Config
    from distributed_tensorflow_example_tpu_torch.ops import fused
    from distributed_tensorflow_example_tpu_torch.parallel import (
        epoch, mesh as mesh_lib, step)
    from distributed_tensorflow_example_tpu_torch.train import loop, optim
    from distributed_tensorflow_example_tpu_torch.train.state import (
        create_train_state)
    from distributed_tensorflow_example_tpu_torch.utils import prng

    device = args["device"]
    base = Config(**dict(args["base"], hidden_sizes=tuple(
        args["base"]["hidden_sizes"])), device=device, num_processes=1,
        task_index=0, coordinator_address=f"127.0.0.1:{_free_port()}")
    if not cluster.bootstrap(base):
        raise AssertionError("dp: cluster.bootstrap set up no group")
    tmp = tempfile.mkdtemp(prefix="dtx-dp-")
    # the runs train on the same synthetic split: made once (4 s a
    # time at 65,536 examples), handed to each run as load_datasets
    real_load, loaded = loop.load_datasets, {}

    def load_once(*a, **k):
        key = repr((a, sorted(k.items())))
        if key not in loaded:
            loaded[key] = real_load(*a, **k)
        return loaded[key]

    loop.load_datasets = load_once
    runs = {}
    t_phase = time.monotonic()
    for name, flags in DP_RUNS.items():
        cfg = dataclasses.replace(base, **flags,
                                  checkpoint_dir=os.path.join(tmp, name))
        _sync(device)
        if device == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        fused.reset_launch_counts()
        t_run = time.monotonic()
        res, out = _run_captured(loop.run, cfg)
        _sync(device)
        t_run = time.monotonic() - t_run
        counts = fused.launch_counts()
        _require(counts, TRAIN_WRAPPERS, (), f"dp {name}", device)
        if res["fast_loop"] != cfg.fast_loop:
            raise AssertionError(f"dp {name}: took fast_loop="
                                 f"{res['fast_loop']}")
        costs = re.findall(r"Cost: ([^,\s]+)", out)
        if len(costs) != res["steps"] + 1 or not all(
                math.isfinite(float(c)) for c in costs):
            raise AssertionError(f"dp {name}: printed costs {costs}")
        t_load = time.monotonic()
        # the final checkpoint's params alone (np.load reads lazily)
        with np.load(_latest_ckpt(cfg.checkpoint_dir)) as z:
            params = {k: z[k] for k in z.files if k.startswith(".params/")}
        log(f"[dp] {name}: run {t_run:.2f} s (its own total "
            f"{res['total_time_s']:.2f} s), reading its checkpoint "
            f"{time.monotonic() - t_load:.2f} s")
        if cfg.sync_period > 1:     # the replicas stacked [dp, ...]
            params = {k: v[0] for k, v in params.items()}
        runs[name] = dict(
            counts=counts, params=params, steps=res["steps"],
            fast_loop=res["fast_loop"],
            peak_gib=(torch.cuda.max_memory_allocated() / 2 ** 30
                      if device == "cuda" else None))
    loop.load_datasets = real_load
    shutil.rmtree(tmp, ignore_errors=True)
    log(f"[dp] the runs took {time.monotonic() - t_phase:.1f} s")
    for name, r in runs.items():
        ref = runs[DP_REF[name]]
        r["bitwise"] = all(np.array_equal(r["params"][k], ref["params"][k])
                           for k in ref["params"])
        r["max_rel_err"] = max(
            float(np.abs(r["params"][k].astype(np.float64)
                         - ref["params"][k]).max())
            / max(float(np.abs(ref["params"][k]).max()), 1e-30)
            for k in ref["params"])
        if sorted(r["params"]) != sorted(ref["params"]):
            raise AssertionError(f"dp {name}: param keys differ")
        if name in ("sync_period", "fsdp_nans") and not r["bitwise"]:
            raise AssertionError(f"dp {name}: final params not bitwise the "
                                 f"plain run's ({r['max_rel_err']:.3g})")
        if not r["max_rel_err"] <= DP_PARAMS_RTOL:
            raise AssertionError(f"dp {name}: final params differ from "
                                 f"{DP_REF[name]}'s by {r['max_rel_err']} "
                                 f"of scale > {DP_PARAMS_RTOL}")
        if r["counts"]["mlp_forward"] != ref["counts"]["mlp_forward"]:
            raise AssertionError(
                f"dp {name}: B1 launched {r['counts']['mlp_forward']} times,"
                f" {DP_REF[name]} {ref['counts']['mlp_forward']}")
    for r in runs.values():
        del r["params"]
    # --debug_nans on the blow-up (learning rate 1e30): the FSDP step
    # raises at the synchronous step's first non-finite step, with its
    # message (the same leaves, the counts of the gradient shards summed)
    blowup = {}
    for name, flags in (("sync", {}), ("fsdp", dict(fsdp=True))):
        cfg = dataclasses.replace(base, **flags, fast_loop=False,
                                  debug_nans=True, learning_rate=1e30,
                                  naive_ce=True)
        try:
            _run_captured(loop.run, cfg)
            blowup[name] = None
        except FloatingPointError as e:
            blowup[name] = str(e)
    log(f"[dp] --debug_nans blow-up: sync {blowup['sync']!r}; fsdp "
        f"{blowup['fsdp']!r}")
    if blowup["fsdp"] is None or blowup["fsdp"] != blowup["sync"]:
        raise AssertionError(f"dp: --debug_nans under --fsdp raised "
                             f"{blowup['fsdp']!r}, the synchronous step "
                             f"{blowup['sync']!r}")
    runs["fsdp_nans"]["blowup"] = blowup["fsdp"]

    # each strategy's step timed, and its collectives profiled, in the
    # same group
    if not torch.distributed.is_initialized():
        raise AssertionError("dp: a run closed the group it found")
    mesh = mesh_lib.build_mesh(-1)
    spec = loop.make_spec(base)
    data = next(iter(loaded.values())).train
    key = prng.PRNGKey(base.seed + epoch.SHUFFLE_SALT)
    seen = set()
    # a first window pays the profiler's start-up and the group's first
    # collective (the communicator's set-up): not measured
    _dp_collectives_ms(device, lambda: torch.distributed.all_reduce(
        torch.zeros(1, device=device)))
    for name, flags in DP_RUNS.items():
        cfg = dataclasses.replace(base, **flags)
        opt = optim.make_optimizer(cfg, 8)
        strat = loop.setup_strategy(
            cfg, spec, opt, create_train_state(spec, opt, seed=cfg.seed,
                                               device=device),
            mesh, fast=cfg.fast_loop)
        body = strat.body or step.make_sync_step_body(cfg, spec, opt)
        img, lbl, spe = epoch.shard_dataset(data.images, data.labels,
                                            cfg.batch_size, device)
        state = strat.state
        x = epoch.normalize(img[:cfg.batch_size])
        y = lbl[:cfg.batch_size]

        def eager():
            new = body(state, x, y)[0]
            return step.param_sync(new) if strat.sync_period else new

        runner = None
        # the graph strategies' eager bodies are their host twins': one
        # window each pair
        twin = {"plain": "plain_host", "fsdp": "fsdp_host"}.get(name)
        coll = (_dp_collectives_ms(device, eager) if twin is None
                else None)
        seen |= set(coll) if name == "fsdp_host" else set()
        if cfg.fast_loop:
            runner = epoch.build_run_to_completion(
                cfg, spec, opt, spe, 1, device, body=strat.body,
                sync_period=strat.sync_period)
            ep = [0]

            def one_epoch():
                nonlocal state
                state = runner(state, img, lbl, key, ep[0])[0]
                ep[0] += 1

            step_ms = _dp_time(device, one_epoch, 3) / spe
        else:
            def one_step():
                nonlocal state
                state = body(state, x, y)[0]

            step_ms = _dp_time(device, one_step, spe)
        runs[name].update(step_ms=step_ms, collectives_ms=coll)
        log(f"[dp] {name}: timed and profiled by "
            f"{time.monotonic() - t_phase:.1f} s")
        del runner, state, strat
        if device == "cuda":
            torch.cuda.empty_cache()
    for name, twin in (("plain", "plain_host"), ("fsdp", "fsdp_host")):
        runs[name]["collectives_ms"] = runs[twin]["collectives_ms"]
    cluster.shutdown()
    log(f"[dp] the phase's child took {time.monotonic() - t_phase:.1f} s")
    missing = [k for k in DP_COLLECTIVES if k not in seen]
    if missing:
        raise AssertionError(f"dp: the FSDP step's profiler window names "
                             f"no {missing} collective")
    return runs


def phase_dp(card: str, base=DP_BASE, device: str = "cuda",
             timeout: float = 300) -> dict:
    """Data parallelism in a one-rank process group (phase 5d), in a
    subprocess (``dp_child``): WIDE_TRAIN under Adam for 8 steps,
    plain (graph and host path), ``--zero_opt``, ``--fsdp`` (graph and
    host path), ``--sync_period=2`` (graph) and ``--fsdp --debug_nans``
    (host; phase 7e (e): bitwise the ``--fsdp`` host run, and on the
    blow-up it raises the synchronous step's ``FloatingPointError``).
    Each run's final params against the plain run's on its path
    (``DP_REF``: ``--sync_period=2`` and ``--fsdp --debug_nans``
    bitwise, ZeRO-1 and FSDP within DP_PARAMS_RTOL), B1's launches equal
    to the plain run's (11 on the graph path: 2 warm-up steps, 8 replays
    and the eval), the all-gather, reduce-scatter and all-reduce named in
    the profiler window over the FSDP step; prints each strategy's step
    ms (CUDA events: the median graph epoch's replays over its steps,
    shuffle included, or the median eager host step), peak memory and
    collectives' device ms."""
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "dp.json")
        args = json.dumps(dict(base=base, device=device, out=out))
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--dp-phase", args],
            capture_output=True, text=True, timeout=timeout,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        for line in proc.stdout.splitlines() + proc.stderr.splitlines():
            log(f"  [dp] {line}")
        if proc.returncode:
            raise AssertionError(f"dp: the phase's process exited "
                                 f"{proc.returncode}")
        with open(out) as f:
            runs = json.load(f)
    for name, r in runs.items():
        log(f"[dp] {name} ({DP_RUNS[name] or 'plain'}, one-rank "
            f"{'NCCL' if device == 'cuda' else 'gloo'} group): step "
            f"{r['step_ms']:.4f} ms, peak memory "
            f"{r['peak_gib'] if r['peak_gib'] is None else round(r['peak_gib'], 3)}"
            f" GiB, collectives ms {r['collectives_ms']}, final params vs "
            f"{DP_REF[name]}: bitwise {r['bitwise']} (max rel err "
            f"{r['max_rel_err']:.3g}), B1 launches "
            f"{r['counts']['mlp_forward']} on {card}")
    log(f"[dp] phase 5d took {time.monotonic() - t0:.1f} s")
    return runs


# phase 5e: tensor parallelism at --model_parallel=2 on two gloo ranks on
# the one card (NCCL refuses two ranks on one device; gloo stages the
# CUDA tensors through host memory, so no time here is TP's across
# cards).  transformer_wide_long's widths cut to 2 blocks and batch 2:
# 3 steps (6 examples) and a test set of 2; the flags after the bench
# row's override it
TP_TFM_CUTS = ["--num_blocks=2", "--batch_size=2",
               "--synthetic_train_size=6", "--synthetic_test_size=2"]
TP_TFM_FLAGS = WIDE_LONG_FLAGS + TP_TFM_CUTS
# name: the run's command line (the MLP's: WIDE_TRAIN on the host path,
# as Config fields).  gloo on the card's torch carries all-gather and
# reduce-scatter of CUDA tensors (scripts/torch_gloo_cuda_probe.py,
# PERF.md section 7), so FSDP x TP and ZeRO-1 x TP run here too
TP_RUNS = {
    "tp_tfm": TP_TFM_FLAGS,
    "tp_tfm_fsdp": TP_TFM_FLAGS + ["--fsdp"],
    "tp_tfm_zero": TP_TFM_FLAGS + ["--zero_opt"],
    "tp_mlp": dict(WIDE_TRAIN, fast_loop=False),
}
TP_MP = 2
# each printed cost against the one-rank run's: the row-split products
# add two f32 partial sums where one rank adds one, so a bf16-rounded
# activation can land one ulp (2^-8) apart and carry on; the mean CE of
# the batch moves far less (phase 7b's bound for a bf16 step)
TP_COST_RTOL = 2e-2
# final params against the one-rank run's.  Adam normalises each
# element's update: an element whose gradient is rounding noise (the key
# bias, to which attention is invariant) moves up to ~lr a step in
# either run whatever the noise, so the bound is 2 x lr x steps (x 1.05
# for the bias-corrected step at t <= 3 and the bf16 moments).  The wide
# MLP's SGD update is lr x g; at the reference's N(0, 1) init its logits
# reach ~1e4 (costs ~3e4), so the softmax is one-hot and a bf16 flip of
# the winning logit changes that row's gradient term by O(1) (the
# one-rank run's B1 and the TP run's plain products round differently):
# each leaf within 0.1 of the largest move the one-rank run made it
# (the N(0, 1) weights themselves agree far closer)
TP_ADAM_STEP = 1.05
TP_SGD_UPDATE_RTOL = 0.1
TP_HEADS = 8 // TP_MP


def _tp_cfg(entry, device: str, model_parallel: int, checkpoint_dir):
    """A ``TP_RUNS`` entry's config: a command line, or Config fields."""
    import dataclasses

    from distributed_tensorflow_example_tpu_torch.config import (
        Config, parse_train_config)

    if isinstance(entry, dict):
        cfg = Config(**dict(entry, hidden_sizes=tuple(
            entry.get("hidden_sizes", (100,)))))
    else:
        cfg = parse_train_config(entry)
    return dataclasses.replace(cfg, device=device,
                               model_parallel=model_parallel,
                               checkpoint_dir=checkpoint_dir or "")


def _tp_init(cfg, device: str) -> dict:
    """The seeded initial params every rank of ``cfg``'s runs started
    from, as numpy."""
    from distributed_tensorflow_example_tpu_torch.train import loop, optim
    from distributed_tensorflow_example_tpu_torch.train.state import (
        create_train_state)

    spec = loop.make_spec(cfg)
    state = create_train_state(spec, optim.make_optimizer(cfg),
                               seed=cfg.seed, device=device)
    return {f".params/{k}": v.cpu().numpy()
            for k, v in state.params.items()}


def _params_held(cfg) -> int:
    """The param elements one rank holds: its Megatron shard of each
    leaf (and 1/dp of that under FSDP, dp 1 here)."""
    from distributed_tensorflow_example_tpu_torch.parallel import (
        mesh as mesh_lib, step)
    from distributed_tensorflow_example_tpu_torch.train import loop

    spec = loop.make_spec(cfg)
    dims = mesh_lib.param_pspecs(spec, cfg.model_parallel)
    return sum(math.prod(shape) // (cfg.model_parallel
                                    if dims[k] is not None else 1)
               for k, shape in step.param_shapes(spec).items())


def _tp_run(cfg, what: str, device: str, echo: bool = True) -> dict:
    """``loop.run(cfg)`` with the launch counts and the flash wrappers'
    last shapes zeroed just before and read just after: the counts, the
    shapes, the printed costs and step times, and the run's peak memory
    above what the process held before it."""
    from distributed_tensorflow_example_tpu_torch.ops import (
        flash_attention, fused)
    from distributed_tensorflow_example_tpu_torch.train import loop

    _sync(device)
    base = 0
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    fused.reset_launch_counts()
    for w in flash_attention.KERNEL_WRAPPERS:
        w.last_shape = None
    t0 = time.monotonic()
    if echo:
        res, out = _run_captured(loop.run, cfg)
    else:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = loop.run(cfg)
        out = buf.getvalue()
    _sync(device)
    costs = [float(c) for c in re.findall(r"Cost: ([^,\s]+)", out)]
    # one print a step, a round under --sites (inner_steps steps)
    prints = res["steps"] // cfg.inner_steps
    if len(costs) != prints + (1 if echo else 0) or not all(
            math.isfinite(c) for c in costs):
        raise AssertionError(f"{what}: printed costs {costs}")
    return dict(
        counts=fused.launch_counts(),
        shapes={w.__name__: w.last_shape
                for w in flash_attention.KERNEL_WRAPPERS},
        costs=costs[:prints], steps=res["steps"],
        fast_loop=res["fast_loop"], devices=res["devices"],
        step_ms=[float(m) for m in re.findall(r"AvgTime: +(\d+\.\d+)ms",
                                              out)],
        wall_s=time.monotonic() - t0, params_held=_params_held(cfg),
        peak_gib=((torch.cuda.max_memory_allocated() - base) / 2 ** 30
                  if device == "cuda" else None))


def _tp_step_ms(cfg, device: str, reps: int = 2) -> list:
    """The host wall of ``reps`` warm steps of ``cfg``'s strategy on one
    synthetic batch (after one untimed step), each between a barrier of
    the group (when one is up) and a sync: under gloo, the time of the
    host-staged collectives too."""
    import torch.distributed as dist

    from distributed_tensorflow_example_tpu_torch.data import mnist
    from distributed_tensorflow_example_tpu_torch.parallel import (
        mesh as mesh_lib)
    from distributed_tensorflow_example_tpu_torch.train import loop, optim
    from distributed_tensorflow_example_tpu_torch.train.state import (
        create_train_state)

    spec = loop.make_spec(cfg)
    opt = optim.make_optimizer(cfg, 8)
    mesh = mesh_lib.build_mesh(cfg.data_parallel, cfg.model_parallel)
    strat = loop.setup_strategy(
        cfg, spec, opt, create_train_state(spec, opt, seed=cfg.seed,
                                           device=device), mesh, fast=False)
    split = mnist.synthesize_split(cfg.batch_size, seed=cfg.seed,
                                   input_size=cfg.input_size)
    rows = mesh_lib.batch_layout(mesh, cfg.batch_size)
    x = torch.from_numpy(split.images[rows]).to(device)
    y = torch.from_numpy(split.labels[rows]).to(device)
    state, times = strat.state, []
    for i in range(reps + 1):
        if dist.is_initialized():
            dist.barrier()
        _sync(device)
        t0 = time.perf_counter()
        state = strat.body(state, x, y)[0]
        _sync(device)
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    del state, strat
    return times


def tp_child(args: dict, rank: int) -> dict:
    """Phase 5e's rank ``rank`` (of two): a gloo group on the card set up
    here, which ``loop.run`` finds up and leaves (``cluster.bootstrap``);
    each run of ``args["runs"]`` (``TP_RUNS`` entries) at
    ``--model_parallel=2`` (rank 0 writing its gathered checkpoint);
    then, on the card, the captured MLP epoch must refuse the gloo
    group."""
    import torch.distributed as dist

    from distributed_tensorflow_example_tpu_torch.ops import fused
    from distributed_tensorflow_example_tpu_torch.parallel import epoch
    from distributed_tensorflow_example_tpu_torch.train import loop

    device = args["device"]
    if device == "cuda":
        torch.cuda.set_device(0)
    # a rank that dies leaves the other in a collective: gloo's timeout
    # (30 min by default) cut to two minutes, so the phase fails fast
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{args['port']}",
        world_size=TP_MP, rank=rank,
        timeout=datetime.timedelta(seconds=120))
    runs = {}
    for name, entry in args["runs"].items():
        cfg = _tp_cfg(entry, device, TP_MP,
                      os.path.join(args["tmp"], f"{name}_mp{TP_MP}"))
        runs[name] = _tp_run(cfg, f"tp {name} rank {rank}", device,
                             echo=rank == 0)
        runs[name]["warm_step_ms"] = _tp_step_ms(cfg, device)
        log(f"[tp] rank {rank} {name}: {runs[name]['wall_s']:.1f} s")
    if device == "cuda":
        import dataclasses

        cfg = dataclasses.replace(
            _tp_cfg(TP_RUNS["tp_mlp"], device, TP_MP, None), fast_loop=True)
        fused.reset_launch_counts()
        refused = None
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                loop.run(cfg)
        except ValueError as e:
            if str(e) != epoch.GLOO_CAPTURE_REFUSED:
                raise
            refused = str(e)
        if refused is None:
            raise AssertionError("tp: the captured MLP epoch ran over gloo")
        if fused.launch_counts()["mlp_forward"]:
            raise AssertionError("tp: B1 launched before the refusal")
        runs["refused"] = refused
    dist.barrier()
    dist.destroy_process_group()
    return runs


def phase_tp(card: str, device: str = "cuda", runs=None,
             timeout: float = 600) -> dict:
    """Tensor parallelism at mp 2 on two gloo ranks (phase 5e): for each
    run of ``runs``, first the one-rank run of the same flags here (no
    group), then both ranks in their own processes (``tp_child``).
    Each rank's printed costs within TP_COST_RTOL of the one-rank run's,
    rank 0's gathered final params within the Adam or SGD bound of its
    checkpoint; every transformer rank launched B2-B7, B5-B7 on
    ``TP_HEADS`` heads; the TP MLP launched no B1 (13 in its one-rank
    host run); the captured MLP epoch refused the gloo group.  Prints
    each run's step ms (host clock, gloo-bound), peak memory and params
    held per rank beside the one-rank run's."""
    t0 = time.monotonic()
    runs = runs or TP_RUNS
    tmp = tempfile.mkdtemp(prefix="dtx-tp-")
    refs = {}
    for name, entry in runs.items():
        cfg = _tp_cfg(entry, device, 1, os.path.join(tmp, f"{name}_mp1"))
        refs[name] = _tp_run(cfg, f"tp {name} one rank", device)
        refs[name]["warm_step_ms"] = _tp_step_ms(cfg, device)
        log(f"[tp] one-rank {name}: {refs[name]['wall_s']:.1f} s")
    if device == "cuda":
        torch.cuda.empty_cache()
    out = os.path.join(tmp, "tp.json")
    args = json.dumps(dict(device=device, runs=runs, tmp=tmp, out=out,
                           port=_free_port()))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--tp-phase", args,
         str(r)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=os.path.dirname(os.path.abspath(__file__)))
        for r in range(TP_MP)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, logs)):
        for line in text.splitlines():
            log(f"  [tp {r}] {line}")
        if p.returncode:
            raise AssertionError(f"tp: rank {r} exited {p.returncode}")
    ranks = []
    for r in range(TP_MP):
        with open(f"{out}.{r}") as f:
            ranks.append(json.load(f))
    result, faults = {}, []
    for name, entry in runs.items():
        ref = refs[name]
        cfg = _tp_cfg(entry, device, TP_MP, None)
        mine = [rk[name] for rk in ranks]
        for r, m in enumerate(mine):
            if m["devices"] != TP_MP or m["steps"] != ref["steps"]:
                faults.append(f"{name} rank {r}: {m['devices']} devices, "
                              f"{m['steps']} steps")
            m["cost_rel_err"] = max(abs(a - b) / max(abs(b), 1e-6)
                                    for a, b in zip(m["costs"], ref["costs"]))
            if (len(m["costs"]) != len(ref["costs"])
                    or m["cost_rel_err"] > TP_COST_RTOL):
                faults.append(f"{name} rank {r}: costs {m['costs']} vs one "
                              f"rank {ref['costs']} (> {TP_COST_RTOL})")
        got = {k: v for k, v in _npz_params(
            os.path.join(tmp, f"{name}_mp{TP_MP}")).items()
            if k.startswith(".params/")}
        want = {k: v for k, v in _npz_params(
            os.path.join(tmp, f"{name}_mp1")).items()
            if k.startswith(".params/")}
        init = _tp_init(cfg, device)
        if sorted(got) != sorted(want):
            faults.append(f"{name}: param keys differ")
        adam = cfg.optimizer == "adam"
        errs = {}
        for k in want:
            diff = float(np.abs(got[k].astype(np.float64) - want[k]).max())
            update = float(np.abs(want[k].astype(np.float64)
                                  - init[k]).max())
            bound = (2 * cfg.learning_rate * ref["steps"] * TP_ADAM_STEP
                     if adam else TP_SGD_UPDATE_RTOL * update)
            errs[k] = dict(abs=diff, of_update=diff / max(update, 1e-30),
                           bound=bound)
            if not diff <= bound:
                faults.append(f"{name} {k}: final params differ by "
                              f"{diff:.3g} > {bound:.3g}")
        if cfg.model == "transformer":
            for r, m in enumerate(mine):
                for w in TFM_WRAPPERS:
                    if device == "cuda" and m["counts"][w] <= 0:
                        faults.append(f"{name} rank {r}: {w} never launched")
                for w in ("flash_forward", "flash_dq", "flash_dkv"):
                    heads = (m["shapes"][w] or [0, 0, 0])[2]
                    if device == "cuda" and heads != TP_HEADS:
                        faults.append(f"{name} rank {r}: {w} saw {heads} "
                                      f"heads, not {TP_HEADS}")
        else:
            for r, m in enumerate(mine):
                if m["counts"]["mlp_forward"]:
                    faults.append(f"{name} rank {r}: B1 launched "
                                  f"{m['counts']['mlp_forward']} times")
            if device == "cuda" and ref["counts"]["mlp_forward"] != 13:
                faults.append(f"{name}: B1 launched "
                              f"{ref['counts']['mlp_forward']} times in the "
                              f"one-rank host run, not 13")
        worst = max(e["abs"] for e in errs.values())
        result[name] = dict(ranks=mine, ref=ref, params_max_abs_err=worst,
                            params_err=errs)
        for r, m in enumerate(mine):
            log(f"[tp] {name} rank {r} (mp {TP_MP}, gloo): warm steps "
                f"{m['warm_step_ms']} ms, the run's wall a step "
                f"{m['step_ms'][-1]} ms (host clock, gloo-bound), peak memory "
                f"{m['peak_gib']} GiB, {m['params_held']} params held, "
                f"costs rel err {m['cost_rel_err']:.3g}, flash shapes "
                f"{m['shapes']['flash_forward']} on {card}")
        log(f"[tp] {name} one rank: warm steps {ref['warm_step_ms']} ms, "
            f"the run's wall a step {ref['step_ms'][-1]} ms, peak memory "
            f"{ref['peak_gib']} GiB, {ref['params_held']} params; final "
            f"params max abs err {worst:.3g}, by leaf (abs, of the update, "
            f"bound): " + ", ".join(
                f"{k[8:]} {e['abs']:.3g} {e['of_update']:.3g} "
                f"{e['bound']:.3g}" for k, e in errs.items()))
    if device == "cuda" and "refused" not in ranks[0]:
        faults.append("the captured-epoch refusal was not run")
    if faults:
        raise AssertionError("tp: " + "; ".join(faults))
    if device == "cuda":
        # B5 at a rank's shape: batch 2, S 8192, 4 heads of 128, the
        # training forward's stats form
        from distributed_tensorflow_example_tpu_torch.ops import (
            flash_attention)

        g = _gen(15)
        q, k, v = (torch.randn((2, 8192, TP_HEADS, 128), generator=g,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        b5_ms = event_ms(
            lambda *a: flash_attention.flash_forward(*a, causal=True,
                                                     stats=True),
            (q, k, v))
        log(f"[tp] B5 at a rank's [2, 8192, {TP_HEADS}, 128] bf16 causal: "
            f"{b5_ms:.4f} ms on {card}")
    shutil.rmtree(tmp, ignore_errors=True)
    log(f"[tp] phase 5e took {time.monotonic() - t0:.1f} s")
    return dict(runs=result, b5_rank_ms=b5_ms if device == "cuda" else None)


# phase 5f: multi-site local SGD at --sites 2 on two gloo ranks on the
# one card (rank r is site r at data parallelism 1; gloo stages the
# CUDA tensors of the outer sync through host memory, so the round and
# outer-sync times are gloo's staging, not a deployment's across sites).
# WIDE_TRAIN on the host path at --inner_steps 4 with the Nesterov outer
# step (8 rounds of one 8192 batch), then under --outer_quant int8;
# transformer_wide_long cut as phase 5e cuts it, at batch 4 (a round
# needs 2 rows a rank for its 2 inner steps): 2 rounds and a test set
# of 2
SITE_MLP = dict(WIDE_TRAIN, fast_loop=False, sites=2, inner_steps=4,
                outer_optimizer="nesterov", outer_lr=0.7,
                outer_momentum=0.9)
SITE_TFM_CUTS = ["--num_blocks=2", "--batch_size=4",
                 "--synthetic_train_size=8", "--synthetic_test_size=2",
                 "--sites=2", "--inner_steps=2"]
SITE_RUNS = {
    "site_mlp": SITE_MLP,
    "site_mlp_int8": dict(SITE_MLP, outer_quant="int8"),
    "site_tfm": WIDE_LONG_FLAGS + SITE_TFM_CUTS,
}
SITES = 2
# the equivalences at SGD inner steps (run (c)): every rank's products
# are bitwise the same in both runs of a pair (B1 on the same params and
# rows), so the params differ only by the rounding of the outer step p0
# - 1 x mean(p0 - p) against the all-reduce's or the replicas' mean: a
# few f32 ulps of the largest param.  The H1 pair is held after one
# round: from the second on, those ulps reach B1's bf16 operands, and at
# the wide MLP's N(0, 1) init (logits ~1e4, a one-hot softmax) a flipped
# bf16 rounding moves a row's gradient by O(1) (phase 5e's note), 2.8e-3
# of the largest param after three rounds on the card
SITE_EQUIV_RTOL = 1e-6


class _RoundWatch:
    """Wraps ``local_sgd.build_local_sgd_step`` and ``_site_mean_tree``
    while a phase 5f run trains: each round's host wall and its outer
    sync's (synced before and after), the bytes of the leaves the round
    hands the outer sync, its cost, and a digest of the params after it
    (for the bitwise check across the ranks)."""

    def __init__(self, device: str):
        from distributed_tensorflow_example_tpu_torch.parallel import (
            local_sgd)

        self.lib, self.device = local_sgd, device
        self.build, self.mean = (local_sgd.build_local_sgd_step,
                                 local_sgd._site_mean_tree)
        self.reset()
        local_sgd.build_local_sgd_step = self._build
        local_sgd._site_mean_tree = self._mean

    def reset(self) -> None:
        self.round_ms, self.sync_ms, self.bytes = [], [], []
        self.costs, self.digests = [], []
        self.in_round = False

    def close(self) -> None:
        self.lib.build_local_sgd_step = self.build
        self.lib._site_mean_tree = self.mean

    def _mean(self, tree, mesh):
        if not self.in_round:
            return self.mean(tree, mesh)
        self.bytes.append(sum(v.numel() * v.element_size()
                              for v in tree.values()))
        _sync(self.device)
        t0 = time.perf_counter()
        out = self.mean(tree, mesh)
        _sync(self.device)
        self.sync_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def _build(self, *args, **kw):
        body = self.build(*args, **kw)

        def round_step(state, x, y):
            _sync(self.device)
            t0 = time.perf_counter()
            self.in_round = True
            try:
                out = body(state, x, y)
                _sync(self.device)
            finally:
                self.in_round = False
            self.round_ms.append((time.perf_counter() - t0) * 1e3)
            self.costs.append(float(out[1]))
            self.digests.append(_digest(out[0].params))
            return out

        return round_step


def _digest(params: dict) -> list:
    """One int per leaf over the leaf's bits (each element's bit pattern
    times a position weight, summed in int64 with wraparound): equal
    digests on two ranks mean, with overwhelming odds, bitwise-equal
    params; the params themselves never leave the card."""
    out = []
    for k in sorted(params):
        v = params[k].detach().contiguous().reshape(-1)
        bits = v.view({4: torch.int32, 2: torch.int16}[v.element_size()])
        w = torch.arange(bits.numel(), device=bits.device,
                         dtype=torch.int64) % 65521 + 1
        out.append(int(torch.sum(bits.to(torch.int64) * w)))
    return out


def _site_run(cfg, what: str, device: str, watch: _RoundWatch,
              echo: bool) -> dict:
    """``_tp_run`` of a ``--sites`` config under the round watch (reset
    just before): its counts, printed costs (one a round), peak memory,
    and the rounds' walls, outer syncs, bytes, costs and digests."""
    watch.reset()
    out = _tp_run(cfg, what, device, echo)
    rounds = len(watch.round_ms)
    if out["steps"] != rounds * cfg.inner_steps or not all(
            math.isfinite(c) for c in watch.costs):
        raise AssertionError(f"{what}: {out['steps']} steps in {rounds} "
                             f"rounds, round costs {watch.costs}")
    out.update(costs=watch.costs, digests=watch.digests,
               round_ms=watch.round_ms, sync_ms=watch.sync_ms,
               bytes=watch.bytes, rounds=rounds)
    return out


def _site_equiv(base: dict, device: str, rank: int) -> dict:
    """Run (c), on this rank's rows of four seeded batches: one round of
    ``--inner_steps 1`` with outer SGD at lr 1 against one step of the
    synchronous step at dp 2, and one round of ``--inner_steps 4``
    against four ``--sync_period 4`` steps and the average; each pair's
    final params as the largest difference over the largest param, and
    the launch counts of all four."""
    import dataclasses

    from distributed_tensorflow_example_tpu_torch.data import mnist
    from distributed_tensorflow_example_tpu_torch.ops import fused
    from distributed_tensorflow_example_tpu_torch.parallel import (
        mesh as mesh_lib, step)
    from distributed_tensorflow_example_tpu_torch.train import loop, optim
    from distributed_tensorflow_example_tpu_torch.train.state import (
        create_train_state)

    cfg = _tp_cfg(dict(base, optimizer="sgd", sites=1, inner_steps=1),
                  device, 1, None)
    spec = loop.make_spec(cfg)
    b = cfg.batch_size
    split = mnist.synthesize_split(4 * b, seed=cfg.seed + 7,
                                   input_size=cfg.input_size)
    rows = slice(rank * b // 2, (rank + 1) * b // 2)
    batches = [(torch.from_numpy(split.images[i * b:(i + 1) * b][rows])
                .to(device),
                torch.from_numpy(split.labels[i * b:(i + 1) * b][rows])
                .to(device)) for i in range(4)]
    site, data = mesh_lib.build_site_mesh(SITES), mesh_lib.build_mesh(-1)

    def strat(mesh, **flags):
        c = dataclasses.replace(cfg, **flags)
        opt = optim.make_optimizer(c)
        return loop.setup_strategy(
            c, spec, opt, create_train_state(spec, opt, seed=c.seed,
                                             device=device), mesh,
            fast=False)

    def rel(a: dict, b_: dict) -> float:
        return max(float((a[k].float() - b_[k].float()).abs().max())
                   / max(float(b_[k].float().abs().max()), 1e-30)
                   for k in b_)

    sgd1 = dict(sites=SITES, outer_optimizer="sgd", outer_lr=1.0)
    _sync(device)
    fused.reset_launch_counts()
    s1, sd = strat(site, inner_steps=1, **sgd1), strat(data)
    x, y = batches[0]
    h1 = rel(s1.body(s1.state, x, y)[0].params,
             sd.body(sd.state, x, y)[0].params)
    s4, sp = strat(site, inner_steps=4, **sgd1), strat(data, sync_period=4)
    st4 = s4.body(s4.state, torch.cat([x for x, _ in batches]),
                  torch.cat([y for _, y in batches]))[0]
    stp = sp.state
    for x, y in batches:
        stp = sp.body(stp, x, y)[0]
    stp = step.param_sync(stp)
    h4 = rel(st4.params, stp.params)
    _sync(device)
    return dict(h1_vs_dp2=h1, h4_vs_sync_period4=h4,
                counts=fused.launch_counts(), digests=_digest(st4.params))


def site_child(args: dict, rank: int) -> dict:
    """Phase 5f's rank ``rank`` (site ``rank``): a gloo group on the card
    set up here, which ``loop.run`` finds up and leaves; each run of
    ``args["runs"]`` under the round watch (rank 0 echoing its stdout),
    then run (c)'s equivalences."""
    import torch.distributed as dist

    device = args["device"]
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{args['port']}",
        world_size=SITES, rank=rank,
        timeout=datetime.timedelta(seconds=120))
    watch = _RoundWatch(device)
    runs = {}
    try:
        for name, entry in args["runs"].items():
            cfg = _tp_cfg(entry, device, 1,
                          os.path.join(args["tmp"], name))
            runs[name] = _site_run(cfg, f"sites {name} rank {rank}", device,
                                   watch, echo=rank == 0)
            log(f"[sites] rank {rank} {name}: {runs[name]['wall_s']:.1f} s")
    finally:
        watch.close()
    runs["site_equiv"] = _site_equiv(args["equiv"], device, rank)
    dist.barrier()
    dist.destroy_process_group()
    return runs


def phase_sites(card: str, device: str = "cuda", runs=None,
                equiv=None, timeout: float = 600) -> dict:
    """Multi-site local SGD at --sites 2 on two gloo ranks (phase 5f),
    each rank in its own process (``site_child``).  Every printed and
    round cost finite, both ranks' params bitwise equal after every
    round (their digests), the outer sync's payload the f32
    pseudo-gradient (``obs/flops``' closed form over 2 sites), B1
    launched in every rank of the MLP runs and the equivalences, B2-B7
    in every rank of the transformer run, the equivalences within
    SITE_EQUIV_RTOL.  Prints each run's round and outer-sync ms (host
    clock, gloo's staging), bytes a round beside the closed forms, and
    peak memory."""
    from distributed_tensorflow_example_tpu_torch.obs import flops
    from distributed_tensorflow_example_tpu_torch.train import loop

    t0 = time.monotonic()
    runs = runs or SITE_RUNS
    equiv = equiv or WIDE_TRAIN
    tmp = tempfile.mkdtemp(prefix="dtx-sites-")
    out = os.path.join(tmp, "sites.json")
    args = json.dumps(dict(device=device, runs=runs, equiv=equiv, tmp=tmp,
                           out=out, port=_free_port()))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--site-phase", args,
         str(r)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=os.path.dirname(os.path.abspath(__file__)))
        for r in range(SITES)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, logs)):
        for line in text.splitlines():
            log(f"  [sites {r}] {line}")
        if p.returncode:
            raise AssertionError(f"sites: rank {r} exited {p.returncode}")
    ranks = []
    for r in range(SITES):
        with open(f"{out}.{r}") as f:
            ranks.append(json.load(f))
    faults = []
    for name, entry in runs.items():
        cfg = _tp_cfg(entry, device, 1, None)
        spec = loop.make_spec(cfg)
        mine = [rk[name] for rk in ranks]
        f32_form = flops.local_sgd_comm_bytes_per_round(spec, SITES)
        int8_form = flops.local_sgd_outer_quant_bytes_per_round(spec, SITES)
        payload = 4 * flops.num_params(spec)
        for r, m in enumerate(mine):
            if m["devices"] != SITES or m["fast_loop"]:
                faults.append(f"{name} rank {r}: {m['devices']} devices, "
                              f"fast_loop {m['fast_loop']}")
            if any(b != payload for b in m["bytes"]):
                faults.append(f"{name} rank {r}: outer sync bytes "
                              f"{sorted(set(m['bytes']))} != {payload}")
            wrappers = (TFM_WRAPPERS if cfg.model == "transformer"
                        else TRAIN_WRAPPERS)
            for w in wrappers:
                if device == "cuda" and m["counts"][w] <= 0:
                    faults.append(f"{name} rank {r}: {w} never launched")
        if mine[0]["digests"] != mine[1]["digests"]:
            bad = [i for i, (a, b) in enumerate(zip(mine[0]["digests"],
                                                    mine[1]["digests"]))
                   if a != b]
            faults.append(f"{name}: the sites' params differ after rounds "
                          f"{bad}")
        if mine[0]["costs"] != mine[1]["costs"]:
            faults.append(f"{name}: the ranks' round costs differ")
        for r, m in enumerate(mine):
            m.update(payload=payload, f32_form=f32_form, int8_form=int8_form)
            log(f"[sites] {name} rank {r} ({SITES} sites, gloo on one "
                f"card): {m['rounds']} rounds of {cfg.inner_steps} inner "
                f"steps, round ms median "
                f"{statistics.median(m['round_ms']):.2f} of "
                f"{[round(t, 2) for t in m['round_ms']]}, outer sync ms "
                f"median {statistics.median(m['sync_ms']):.2f} (host clock, "
                f"gloo's host staging), payload {payload} B a round (the "
                f"f32 pseudo-gradient; ring all-reduce per site "
                f"{f32_form:.0f} B, an int8 wire {int8_form:.0f} B), peak "
                f"memory {m['peak_gib']} GiB, costs {m['costs']} on {card}")
    eq = [rk["site_equiv"] for rk in ranks]
    for r, e in enumerate(eq):
        for k in ("h1_vs_dp2", "h4_vs_sync_period4"):
            if not e[k] <= SITE_EQUIV_RTOL:
                faults.append(f"site_equiv rank {r}: {k} {e[k]:.3g} > "
                              f"{SITE_EQUIV_RTOL}")
        if device == "cuda" and e["counts"]["mlp_forward"] <= 0:
            faults.append(f"site_equiv rank {r}: B1 never launched")
        log(f"[sites] equivalences rank {r}: H1 outer SGD(1) vs dp 2 "
            f"{e['h1_vs_dp2']:.3g}, H4 vs --sync_period 4 "
            f"{e['h4_vs_sync_period4']:.3g} of the largest param (bound "
            f"{SITE_EQUIV_RTOL}) on {card}")
    if eq[0]["digests"] != eq[1]["digests"]:
        faults.append("site_equiv: the sites' params differ after the H4 "
                      "round")
    if faults:
        raise AssertionError("sites: " + "; ".join(faults))
    shutil.rmtree(tmp, ignore_errors=True)
    log(f"[sites] phase 5f took {time.monotonic() - t0:.1f} s")
    return dict(ranks=ranks)


# phase 5g: sequence parallelism at --sequence_parallel 2 on two gloo
# ranks on the one card (NCCL refuses two ranks on one device; gloo's
# point-to-point ops take a CUDA tensor's pointer as host memory, so the
# ring's rotations run as zero-split all_to_all_single, which gloo stages
# through the host: the step times are gloo's staging, not SP's across
# cards).  transformer_wide_long cut as phase 5e cuts it (2 blocks,
# batch 2, 3 steps, a test set of 2), once under the ring and once under
# Ulysses; each rank holds [2, 4096, 8, 128] of q/k/v (ring) or
# [2, 8192, 4, 128] after the exchange (Ulysses).  Sequence parallelism
# takes the host path (JAX's gate), so the one-rank run it is held to
# takes it too (--no_fast_loop: the same batches in the same order)
SP_DEG = 2
SP_RUNS = {
    "sp_ring": TP_TFM_FLAGS + ["--no_fast_loop", "--sp_impl=ring"],
    "sp_ulysses": TP_TFM_FLAGS + ["--no_fast_loop", "--sp_impl=ulysses"],
}
# each printed cost against the one-rank run's: the ring merges two
# blocks' softmax partials where one launch runs the whole row, and a
# bf16 activation can then round one ulp apart and carry on (phase 5e's
# bound); the final params within phase 5e's Adam bound
SP_COST_RTOL = TP_COST_RTOL
# the first step's gradients (summed over the token group) against the
# one-rank run's, each leaf and the whole in relative L2.  Measured on
# the card (H100, 700 W): 1.86e-3-1.87e-3 whole, 2.24e-3 the worst leaf
# (the bf16 ring and Ulysses against one launch a row); two broken
# backward rings (past blocks' dk/dv dropped, the dk/dv accumulators
# not brought home) 0.172-0.264 whole, 0.402-1.07 the worst leaf
SP_GRAD_RTOL = 1e-2
# the loopback's bytes over the bytes both ranks posted: TCP/IP headers
# and acknowledgements, and the barriers' few bytes
SP_WIRE_OVER = 1.10
# B5-B7's launches a rank a run (3 training steps and one eval forward,
# 2 blocks each): the causal ring at sp 2 runs the diagonal block on
# rank 0 (the past block it would meet second is in its future) and the
# diagonal and the past block on rank 1; Ulysses one full-sequence
# launch a block on every rank
SP_LAUNCHES = {
    "sp_ring": [dict(flash_forward=8, flash_dq=6, flash_dkv=6),
                dict(flash_forward=16, flash_dq=12, flash_dkv=12)],
    "sp_ulysses": [dict(flash_forward=8, flash_dq=6, flash_dkv=6)] * 2,
}


def _scope_kernels(events, scope: str) -> list:
    """The names of the device kernels, in a Chrome trace's events,
    whose launch (the runtime call correlated with them) lies inside a
    ``scope`` range (a ``record_function`` range) on the host."""
    ranges = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
              if e.get("cat") == "user_annotation"
              and e.get("name") == scope]
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    out = []
    for e in events:
        t = launch.get(e.get("args", {}).get("correlation"))
        if e.get("cat") == "kernel" and t is not None and any(
                lo <= t <= hi for lo, hi in ranges):
            out.append(e["name"])
    return out


def _card_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _sp_cfg(entry, device: str, sp: int, checkpoint_dir):
    import dataclasses

    return dataclasses.replace(_tp_cfg(entry, device, 1, checkpoint_dir),
                               sequence_parallel=sp)


def _sp_closed_bytes(cfg) -> int:
    """The bytes one rank posts to the seq axis's collectives in one
    training step, in closed form.  Ring at n ranks, each block: the forward rotates the
    stacked k/v (bf16) n - 1 times, the backward n - 1 times more and
    its f32 dk/dv accumulators n times.  Ulysses, each block: the
    stacked q/k/v exchanged to heads and the output back, and the two
    gradients' exchanges in the backward, each sending (n - 1) / n of
    its buffer."""
    from distributed_tensorflow_example_tpu_torch.device import (
        dtype_from_name)

    n = cfg.sequence_parallel
    el = torch.empty((), dtype=dtype_from_name(cfg.compute_dtype)
                     ).element_size()
    d = cfg.d_model // cfg.n_heads
    block = cfg.batch_size * (cfg.seq_len // n) * cfg.n_heads * d
    if cfg.sp_impl == "ring":
        per = (2 * (n - 1) * 2 * block * el + n * 2 * block * 4)
    else:
        per = 2 * (3 * block * el + block * el) * (n - 1) // n
    return cfg.num_blocks * per


def _sp_step(cfg, device: str, reps: int = 2) -> dict:
    """``reps`` warm steps of ``cfg``'s strategy on one synthetic batch
    (after a first step from the seeded init), each between a barrier of
    the group (when one is up) and a sync (host clock: under gloo the
    staged collectives' time too); the bytes the last one posted over
    the seq axis (``parallel/mesh.SEQ_BYTES``: the tensors handed to the
    rotations and exchanges); and the first step's gradients as the
    optimizer received them (summed over the token group, f32 numpy)."""
    import dataclasses

    import torch.distributed as dist

    from distributed_tensorflow_example_tpu_torch.data import mnist
    from distributed_tensorflow_example_tpu_torch.parallel import (
        mesh as mesh_lib)
    from distributed_tensorflow_example_tpu_torch.train import loop, optim
    from distributed_tensorflow_example_tpu_torch.train.state import (
        create_train_state)

    spec = loop.make_spec(cfg)
    opt = optim.make_optimizer(cfg, 8)
    grads = {}

    def update(g, opt_state, params):
        if not grads:
            grads.update({k: v.detach().float().cpu().numpy()
                          for k, v in g.items()})
        return opt.update(g, opt_state, params)

    grabbing = dataclasses.replace(opt, update=update)
    mesh = mesh_lib.build_seq_mesh(cfg.data_parallel, cfg.sequence_parallel)
    strat = loop.setup_strategy(
        cfg, spec, grabbing, create_train_state(spec, opt, seed=cfg.seed,
                                                device=device), mesh,
        fast=False)
    split = mnist.synthesize_split(cfg.batch_size, seed=cfg.seed,
                                   input_size=cfg.input_size)
    rows = mesh_lib.batch_layout(mesh, cfg.batch_size)
    cols = mesh_lib.seq_columns(mesh, cfg.input_size)
    x = torch.from_numpy(split.images[rows][:, cols]).to(device)
    y = torch.from_numpy(split.labels[rows]).to(device)
    state, times, sent = strat.state, [], 0
    for i in range(reps + 1):
        if dist.is_initialized():
            dist.barrier()
        _sync(device)
        for k in mesh_lib.SEQ_BYTES:
            mesh_lib.SEQ_BYTES[k] = 0
        t0 = time.perf_counter()
        state = strat.body(state, x, y)[0]
        _sync(device)
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
        sent = sum(mesh_lib.SEQ_BYTES.values())
    del state, strat
    return dict(warm_step_ms=times, step_bytes=sent, grads=grads)


def _grad_errs(got: dict, want: dict) -> dict:
    """Each leaf's ``||got - want|| / ||want||`` (L2), and the whole
    gradient's under ``"all"``."""
    errs, num, den = {}, 0.0, 0.0
    for k, w in want.items():
        w = w.astype(np.float64)
        d = float(np.sum((got[k].astype(np.float64) - w) ** 2))
        n = float(np.sum(w ** 2))
        errs[k] = math.sqrt(d / max(n, 1e-300))
        num, den = num + d, den + n
    errs["all"] = math.sqrt(num / max(den, 1e-300))
    return errs


def _lo_bytes():
    """The loopback device's transmitted bytes (``/proc/net/dev``), or
    None where the file or the device is missing."""
    try:
        with open("/proc/net/dev") as f:
            for line in f:
                name, _, rest = line.partition(":")
                if name.strip() == "lo":
                    return int(rest.split()[8])
    except OSError:
        pass
    return None


def _sp_wire(cfg, device: str) -> dict:
    """What one block's attention, forward and backward, at ``cfg``'s
    layout moves between the two ranks: the bytes posted to the seq
    axis's collectives (``SEQ_BYTES``) and the bytes the loopback device
    carried meanwhile (both ranks' traffic, TCP/IP headers included;
    the gloo ranks share this host), each window between barriers after
    one untimed block."""
    import torch.distributed as dist

    from distributed_tensorflow_example_tpu_torch.device import (
        dtype_from_name)
    from distributed_tensorflow_example_tpu_torch.models import transformer
    from distributed_tensorflow_example_tpu_torch.parallel import (
        mesh as mesh_lib)
    from distributed_tensorflow_example_tpu_torch.train import loop

    spec = loop.make_spec(cfg)
    mesh = mesh_lib.build_seq_mesh(cfg.data_parallel, cfg.sequence_parallel)
    axis = mesh_lib.seq_axis(mesh)
    shape = (cfg.batch_size, cfg.seq_len // cfg.sequence_parallel,
             cfg.n_heads, cfg.d_model // cfg.n_heads)
    g = torch.Generator(device=device).manual_seed(17 + mesh.rank)
    cdt = dtype_from_name(cfg.compute_dtype)
    q, k, v, do = (torch.randn(shape, generator=g, device=device).to(cdt)
                   for _ in range(4))
    out = {}
    for i in range(2):
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        dist.barrier()
        for key in mesh_lib.SEQ_BYTES:
            mesh_lib.SEQ_BYTES[key] = 0
        before = _lo_bytes()
        dist.barrier()
        torch.autograd.grad(transformer._attend(spec, *leaves, axis),
                            leaves, do)
        _sync(device)
        dist.barrier()
        after = _lo_bytes()
        out = dict(posted=sum(mesh_lib.SEQ_BYTES.values()),
                   loopback=(None if before is None or after is None
                             else after - before))
    return out


def sp_child(args: dict, rank: int) -> dict:
    """Phase 5g's rank ``rank`` (of two): a gloo group on the card set up
    here, which ``loop.run`` finds up and leaves; each run of
    ``args["runs"]`` at ``--sequence_parallel 2`` (rank 0 writing the
    checkpoint), then its warm steps, its first step's gradients against
    the one-rank run's (``args["grads"]``) and one block's traffic."""
    import torch.distributed as dist

    device = args["device"]
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{args['port']}",
        world_size=SP_DEG, rank=rank,
        timeout=datetime.timedelta(seconds=120))
    runs = {}
    for name, entry in args["runs"].items():
        cfg = _sp_cfg(entry, device, SP_DEG,
                      os.path.join(args["tmp"], f"{name}_sp{SP_DEG}"))
        runs[name] = _tp_run(cfg, f"sp {name} rank {rank}", device,
                             echo=rank == 0)
        step = _sp_step(cfg, device)
        with np.load(args["grads"]) as z:
            step["grad_errs"] = _grad_errs(step.pop("grads"), dict(z))
        runs[name].update(step, wire=_sp_wire(cfg, device))
        log(f"[sp] rank {rank} {name}: {runs[name]['wall_s']:.1f} s on "
            f"{args['card']}")
    dist.barrier()
    dist.destroy_process_group()
    return runs


def check_sp_kernels(card: str) -> list:
    """B5-B7 at the sequence-parallel path's own forms: the ring's past
    block (B5's stats form, B6 and B7, all non-causal) and diagonal
    block (causal) at a rank's [2, 4096, 8, 128], and Ulysses' full
    sequence on a rank's heads [2, 8192, 4, 128] (causal)."""
    return _flash_form_rows(card, "sp", (
        ("ring past block", (2, 4096, 8, 128), False),
        ("ring diagonal block", (2, 4096, 8, 128), True),
        ("ulysses", (2, 8192, 4, 128), True)))


def _flash_form_rows(card: str, path: str, forms) -> list:
    """B5's stats form, B6 and B7 at each ``(tag, shape, causal)`` of
    ``forms`` against their plain versions, within FLASH_TOL, and timed
    beside them, a library call and the bound.  Returns rows for the
    flash kernels' report, each under ``path``."""
    import torch.nn.functional as F

    from distributed_tensorflow_example_tpu_torch.ops import (
        flash_attention as fa)

    cdt = torch.bfloat16
    tol = FLASH_TOL[cdt]
    rows = []
    for tag, shape, causal in forms:
        g = _gen(13000 + shape[1] + int(causal))
        q, k, v, do = (torch.randn(shape, generator=g, device="cuda").to(cdt)
                       for _ in range(4))
        acc, m, l = fa.flash_forward(q, k, v, causal, stats=True)
        acc_r, m_r, l_r = fa.flash_stats_reference(q, k, v, causal)
        fwd = max(_errs(acc, acc_r), _errs(m, m_r), _errs(l, l_r),
                  key=lambda e: e[1])
        o = (acc_r / l_r[..., None]).to(cdt)
        dlt = torch.sum(do.float() * o.float(), dim=-1)
        want = fa.flash_backward_reference(q, k, v, do, m_r, l_r, dlt,
                                           causal)
        dq = fa.flash_dq(q, k, v, do, m_r, l_r, dlt, causal)
        dk, dv = fa.flash_dkv(q, k, v, do, m_r, l_r, dlt, causal)
        e_dq = _errs(dq, want[0])
        e_dkv = max(_errs(dk, want[1]), _errs(dv, want[2]),
                    key=lambda e: e[1])
        del acc, acc_r, want, dq, dk, dv
        torch.cuda.empty_cache()
        for name, e in (("flash_forward", fwd), ("flash_dq", e_dq),
                        ("flash_dkv", e_dkv)):
            if not e[1] <= tol:
                raise AssertionError(f"{path} kernels: {name} {tag} "
                                     f"{list(shape)}: {e[1]} of scale > "
                                     f"{tol}")
        kern = {
            "stats": event_ms(fa.flash_forward, (q, k, v, causal, True)),
            "dq": event_ms(fa.flash_dq, (q, k, v, do, m, l, dlt, causal)),
            "dkv": event_ms(fa.flash_dkv, (q, k, v, do, m, l, dlt, causal)),
        }
        plain = {
            "stats": event_ms(fa.flash_stats_reference, (q, k, v, causal),
                              1),
            "dq": event_ms(lambda *a: fa.flash_backward_reference(*a)[0],
                           (q, k, v, do, m, l, dlt, causal), 1),
            "dkv": event_ms(lambda *a: fa.flash_backward_reference(*a)[1:],
                            (q, k, v, do, m, l, dlt, causal), 1),
        }
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib_fwd = event_ms(lambda a, b_, c: F.scaled_dot_product_attention(
            a, b_, c, is_causal=causal), (qt, kt, vt))
        qg, kg, vg = (t.detach().requires_grad_(True) for t in (qt, kt, vt))
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
        gt = do.transpose(1, 2)
        lib_bwd = event_ms(lambda: torch.autograd.grad(
            out, (qg, kg, vg), gt, retain_graph=True), ())
        del out, qg, kg, vg
        for name, form, e, lib in (("flash_forward", "stats", fwd, lib_fwd),
                                   ("flash_dq", "dq", e_dq, lib_bwd),
                                   ("flash_dkv", "dkv", e_dkv, lib_bwd)):
            nbytes, flops = _flash_bytes_flops(*shape, causal, form)
            bound, by = _bound(nbytes, flops)
            rows.append(dict(
                kernel=name, form=form, path=f"{path} {tag}",
                shape=list(shape),
                dtype="bf16", causal=causal, ms=kern[form],
                plain_ms=plain[form], library_ms=lib,
                library_call=(f"scaled_dot_product_attention(is_causal="
                              f"{causal}) " + ("forward" if form == "stats"
                                               else "backward (dq, dk and "
                                                    "dv together)")),
                bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops,
                tflops=flops / kern[form] / 1e9, x_library=kern[form] / lib,
                max_abs_err=e[0], rel_err=e[1]))
            log(f"[{path}-kernel] {name} ({form}) {tag} {list(shape)} bf16 "
                f"causal={causal}: {e[1]:.3g} of scale (tol {tol}), max abs "
                f"{e[0]:.3g}; kernel {kern[form]:.4f} ms "
                f"({rows[-1]['tflops']:.1f} TFLOP/s), plain "
                f"{plain[form]:.3f} ms, library {lib:.4f} ms, bound "
                f"{bound:.4f} ms ({by}) on {card}")
        del q, k, v, do, m, l, o, dlt
        torch.cuda.empty_cache()
    return rows


def phase_sp(card: str, device: str = "cuda", runs=None,
             timeout: float = 600) -> dict:
    """Sequence parallelism at sp 2 on two gloo ranks (phase 5g): the
    one-rank run of the same flags here (no group), then both ranks in
    their own processes (``sp_child``) under each layout of ``runs``.
    Each rank's printed costs within SP_COST_RTOL of the one-rank run's,
    rank 0's final params within phase 5e's Adam bound of its
    checkpoint; on the card B2-B7 launched in every rank, B5-B7 exactly
    SP_LAUNCHES times and at the rank's shape, the bytes a step posted
    to the seq axis equal to the closed form, each rank's first-step
    gradients within SP_GRAD_RTOL of the one-rank run's and, on the
    card, one block's loopback traffic within SP_WIRE_OVER of the bytes
    posted.  Prints each rank's launches, bytes, gradient errors, warm
    step ms (host clock, gloo-bound) and peak memory beside the one-rank
    run's, each line with the card's name and power limit."""
    t0 = time.monotonic()
    if device == "cuda":
        card = _card_limit()
    runs = runs or SP_RUNS
    tmp = tempfile.mkdtemp(prefix="dtx-sp-")
    first = next(iter(runs.values()))
    ref_cfg = _sp_cfg(first, device, 1, os.path.join(tmp, "one_rank"))
    ref = _tp_run(ref_cfg, "sp one rank", device)
    step = _sp_step(ref_cfg, device)
    grads = os.path.join(tmp, "one_rank_grads.npz")
    np.savez(grads, **step.pop("grads"))
    ref["warm_step_ms"] = step["warm_step_ms"]
    log(f"[sp] one-rank run: {ref['wall_s']:.1f} s on {card}")
    if device == "cuda":
        torch.cuda.empty_cache()
    out = os.path.join(tmp, "sp.json")
    args = json.dumps(dict(device=device, runs=runs, tmp=tmp, out=out,
                           port=_free_port(), card=card, grads=grads))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--sp-phase", args,
         str(r)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=os.path.dirname(os.path.abspath(__file__)))
        for r in range(SP_DEG)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, logs)):
        for line in text.splitlines():
            log(f"  [sp {r}] {line}")
        if p.returncode:
            raise AssertionError(f"sp: rank {r} exited {p.returncode}")
    ranks = []
    for r in range(SP_DEG):
        with open(f"{out}.{r}") as f:
            ranks.append(json.load(f))
    want = {k: v for k, v in _npz_params(os.path.join(tmp, "one_rank"))
            .items() if k.startswith(".params/")}
    init = _tp_init(ref_cfg, device)
    result, faults = {}, []
    for name, entry in runs.items():
        cfg = _sp_cfg(entry, device, SP_DEG, None)
        closed = _sp_closed_bytes(cfg)
        heads = cfg.n_heads // (SP_DEG if cfg.sp_impl == "ulysses" else 1)
        length = cfg.seq_len // (SP_DEG if cfg.sp_impl == "ring" else 1)
        mine = [rk[name] for rk in ranks]
        for r, m in enumerate(mine):
            if (m["devices"] != SP_DEG or m["steps"] != ref["steps"]
                    or m["fast_loop"]):
                faults.append(f"{name} rank {r}: {m['devices']} devices, "
                              f"{m['steps']} steps, fast_loop "
                              f"{m['fast_loop']}")
            m["cost_rel_err"] = max(abs(a - b) / max(abs(b), 1e-6)
                                    for a, b in zip(m["costs"], ref["costs"]))
            if (len(m["costs"]) != len(ref["costs"])
                    or m["cost_rel_err"] > SP_COST_RTOL):
                faults.append(f"{name} rank {r}: costs {m['costs']} vs one "
                              f"rank {ref['costs']} (> {SP_COST_RTOL})")
            m["closed_bytes"] = closed
            if m["step_bytes"] != closed:
                faults.append(f"{name} rank {r}: {m['step_bytes']} B posted "
                              f"a step, closed form {closed}")
            m["grad_worst"] = max((e, k) for k, e in m["grad_errs"].items())
            if not m["grad_worst"][0] <= SP_GRAD_RTOL:
                faults.append(f"{name} rank {r}: the first step's gradient "
                              f"{m['grad_worst'][1]} off the one-rank run's "
                              f"by {m['grad_worst'][0]:.3g} (> "
                              f"{SP_GRAD_RTOL})")
            wire, per_block = m["wire"], closed // cfg.num_blocks
            if wire["posted"] != per_block:
                faults.append(f"{name} rank {r}: {wire['posted']} B posted "
                              f"a block, closed form {per_block}")
            if wire["loopback"] is not None and device == "cuda" and not (
                    SP_DEG * per_block <= wire["loopback"]
                    <= SP_DEG * per_block * SP_WIRE_OVER):
                faults.append(f"{name} rank {r}: the loopback carried "
                              f"{wire['loopback']} B in a block, the ranks "
                              f"posted {SP_DEG * per_block}")
            if device == "cuda":
                for w in TFM_WRAPPERS:
                    if m["counts"][w] <= 0:
                        faults.append(f"{name} rank {r}: {w} never launched")
                for w, n in SP_LAUNCHES[name][r].items():
                    if m["counts"][w] != n:
                        faults.append(f"{name} rank {r}: {w} launched "
                                      f"{m['counts'][w]} times, predicted "
                                      f"{n}")
                    shape = m["shapes"][w] or [0, 0, 0, 0]
                    if shape[1:3] != [length, heads]:
                        faults.append(f"{name} rank {r}: {w} saw {shape}")
        got = {k: v for k, v in _npz_params(
            os.path.join(tmp, f"{name}_sp{SP_DEG}")).items()
            if k.startswith(".params/")}
        if sorted(got) != sorted(want):
            faults.append(f"{name}: param keys differ")
        bound = 2 * cfg.learning_rate * ref["steps"] * TP_ADAM_STEP
        worst = 0.0
        for k in want:
            diff = float(np.abs(got[k].astype(np.float64) - want[k]).max())
            worst = max(worst, diff)
            if not diff <= bound:
                faults.append(f"{name} {k}: final params differ by "
                              f"{diff:.3g} > {bound:.3g}")
        moved = max(float(np.abs(want[k].astype(np.float64) - init[k])
                          .max()) for k in want)
        result[name] = dict(ranks=mine, params_max_abs_err=worst,
                            params_bound=bound, largest_update=moved)
        for r, m in enumerate(mine):
            log(f"[sp] {name} rank {r} (sp {SP_DEG}, gloo on one card): "
                f"B2/B3/B4 launches {m['counts']['fused_layer_norm']}/"
                f"{m['counts']['fused_layer_norm_residual']}/"
                f"{m['counts']['layer_norm_backward']}, B5/B6/B7 "
                f"{m['counts']['flash_forward']}/"
                f"{m['counts']['flash_dq']}/{m['counts']['flash_dkv']} "
                f"(predicted {SP_LAUNCHES[name][r]}), flash shape "
                f"{m['shapes']['flash_forward']}, {m['step_bytes']} B "
                f"posted a step to the seq axis's collectives (closed form "
                f"{closed}), one block's attention forward and backward "
                f"{m['wire']['posted']} B posted and "
                f"{m['wire']['loopback']} B carried by the loopback for "
                f"both ranks, first step's gradient rel L2 err "
                f"{m['grad_errs']['all']:.3g} (worst leaf "
                f"{m['grad_worst'][1]} {m['grad_worst'][0]:.3g}), warm "
                f"steps {[round(t, 2) for t in m['warm_step_ms']]} ms "
                f"(host clock, gloo-bound), peak memory {m['peak_gib']} "
                f"GiB, costs rel err {m['cost_rel_err']:.3g} on {card}")
        log(f"[sp] {name}: final params max abs err {worst:.3g} (bound "
            f"{bound:.3g}; the one-rank run's largest update {moved:.3g}) "
            f"on {card}")
    log(f"[sp] one rank: warm steps "
        f"{[round(t, 2) for t in ref['warm_step_ms']]} ms, peak memory "
        f"{ref['peak_gib']} GiB, B2-B4 launches "
        f"{ref['counts']['fused_layer_norm']}/"
        f"{ref['counts']['fused_layer_norm_residual']}/"
        f"{ref['counts']['layer_norm_backward']}, B5/B6/B7 "
        f"{ref['counts']['flash_forward']}/{ref['counts']['flash_dq']}/"
        f"{ref['counts']['flash_dkv']} on {card}")
    if faults:
        raise AssertionError("sp: " + "; ".join(faults))
    shutil.rmtree(tmp, ignore_errors=True)
    kernels = check_sp_kernels(card) if device == "cuda" else []
    log(f"[sp] phase 5g took {time.monotonic() - t0:.1f} s on {card}")
    return dict(runs=result, ref=ref, kernels=kernels)


# ---------------------------------------------------------------------------
# phase 5h: expert parallelism on two gloo ranks on the one card
# ---------------------------------------------------------------------------

# two gloo ranks at --expert_parallel 2 (dp 1), each in its own process,
# against a one-rank run of the same flags in this process (NCCL refuses
# two ranks on one card; gloo stages every exchange through host memory,
# so the step times are gloo's staging, not EP's across cards).  Expert
# parallelism takes the host path (JAX's gate), so the one-rank runs take
# it too.  (a) moe_wide at full width under sparse dispatch and
# --grouped_moe, 3 steps: each rank holds 32 of the 64 experts and runs
# B8's training form on [32, 640, 1024] x 2048 (its experts' rows from
# both token shards, C 320 a shard); (b) phase 8b's 1-block E 8 cut at
# ample capacity (cf 8: nothing drops), top-2, the balance loss, SGD,
# 3 steps; (c) the same under dense dispatch (the expert_copy /
# expert_psum backward)
EP_DEG = 2
EP_CUT_FLAGS = [
    "--model=transformer", "--num_experts=8", "--moe_topk=2",
    "--capacity_factor=8.0", "--moe_aux_weight=0.01", "--attention=flash",
    "--causal", "--input_size=1024", "--seq_len=256", "--d_model=1024",
    "--n_heads=8", "--num_blocks=1", "--d_ff=2048",
    "--compute_dtype=bfloat16", "--optimizer=sgd", "--learning_rate=1e-2",
    "--batch_size=4", "--dataset=synthetic", "--synthetic_train_size=12",
    "--synthetic_test_size=4", "--no_summaries", "--frequency=1",
    "--training_epochs=1", "--no_fast_loop"]
EP_RUNS = {
    "ep_wide": MOE_WIDE_FLAGS + ["--grouped_moe", "--no_fast_loop",
                                 "--synthetic_train_size=96"],
    "ep_sparse_cut": EP_CUT_FLAGS + ["--moe_dispatch=alltoall",
                                     "--grouped_moe"],
    "ep_dense_cut": EP_CUT_FLAGS + ["--moe_dispatch=dense"],
}
# the runs whose first-step gradients are held to the one-rank run's
EP_CUTS = ("ep_sparse_cut", "ep_dense_cut")
# each printed cost against the one-rank run's: at moe_wide's cf 1.25
# each token shard fills its own capacity (C 320 of its 16 examples'
# 16,384 tokens), so the two ranks drop other tokens than one rank does
# (C 640 of 32,768) and the costs are held loosely (measured on the card,
# H100 700 W: 3.95e-3); the cuts drop nothing, and are held to phase
# 5e's bf16 bound (measured 2.79e-3 sparse, 5.64e-4 dense)
EP_WIDE_COST_RTOL = 5e-2
EP_COST_RTOL = TP_COST_RTOL
# the first step's gradients (as the optimizer receives them, each
# rank's experts against their slice of the one-rank run's) in relative
# L2, each leaf and the whole.  Measured on the card (H100, 700 W):
# 1.85e-3 / 6.0e-4 whole (sparse / dense cut), 2.19e-3 the worst leaf
# (bf16 activations rounded in another order).  Four broken copies on
# the CPU (the ln2 output or the selection entering the experts without
# expert_copy, the balance loss's probs through it, the combine's
# transpose dropped) put a leaf 0.0444-1.36 off
EP_GRAD_RTOL = 1e-2
EP_WIRE_OVER = SP_WIRE_OVER


def _ep_cfg(entry, device: str, ep: int):
    import dataclasses

    from distributed_tensorflow_example_tpu_torch.config import (
        parse_train_config)

    return dataclasses.replace(parse_train_config(entry), device=device,
                               expert_parallel=ep, checkpoint_dir="")


def _ep_sizes(cfg) -> dict:
    """One rank's shapes under ``cfg``: its rows, its capacity C (a
    shard's, sparse), its experts El, and the params it holds (all, and
    of the experts)."""
    from distributed_tensorflow_example_tpu_torch.models import transformer
    from distributed_tensorflow_example_tpu_torch.parallel import step
    from distributed_tensorflow_example_tpu_torch.train import loop

    spec = loop.make_spec(cfg)
    ep = cfg.expert_parallel
    sparse = spec.moe_dispatch == "alltoall" and ep > 1
    rows = cfg.batch_size // (ep if sparse else 1)
    cap = max(1, math.ceil(spec.capacity_factor * rows * spec.seq_len
                           * spec.moe_topk / spec.num_experts))
    expert = set(transformer.expert_leaves(spec))
    shapes = step.param_shapes(spec)
    held = {k: math.prod(v) // (ep if k in expert else 1)
            for k, v in shapes.items()}
    return dict(rows=rows, cap=cap, el=spec.num_experts // ep,
                sparse=sparse, params_held=sum(held.values()),
                expert_params_held=sum(held[k] for k in expert))


def _ep_closed_bytes(cfg) -> int:
    """The bytes one rank posts to the expert axis's collectives in one
    training step, in closed form: sparse, each block four exchanges
    (dispatch and combine, forward and backward) of the f32 ``[E, C,
    d]`` buffer; dense, each block the partial outputs' all-reduce
    forward and the ln2 output's and the selection's backward (f32)."""
    z = _ep_sizes(cfg)
    t = z["rows"] * cfg.seq_len
    if z["sparse"]:
        per = 4 * cfg.num_experts * z["cap"] * cfg.d_model * 4
    else:
        per = (2 * t * cfg.d_model + t * cfg.num_experts) * 4
    return cfg.num_blocks * per


def _ep_step(cfg, device: str, reps: int = 2, grads: bool = False) -> dict:
    """``reps`` warm steps of ``cfg``'s strategy on one synthetic batch
    (after a first step from the seeded init), each between a barrier of
    the group (when one is up) and a sync (host clock: under gloo the
    staged exchanges' time too); the bytes the last one posted to the
    expert axis (``parallel/mesh.EP_BYTES``); a digest of the replicated
    leaves after every step; the flash wrappers' last shapes (a
    training step's); with ``grads`` the first step's gradients as the
    optimizer received them (f32 numpy; this rank's experts)."""
    import dataclasses
    import hashlib

    import torch.distributed as dist

    from distributed_tensorflow_example_tpu_torch.data import mnist
    from distributed_tensorflow_example_tpu_torch.models import transformer
    from distributed_tensorflow_example_tpu_torch.ops import flash_attention
    from distributed_tensorflow_example_tpu_torch.parallel import (
        mesh as mesh_lib)
    from distributed_tensorflow_example_tpu_torch.train import loop, optim
    from distributed_tensorflow_example_tpu_torch.train.state import (
        create_train_state)

    spec = loop.make_spec(cfg)
    opt = optim.make_optimizer(cfg, 8)
    got = {}

    def update(g, opt_state, params):
        if grads and not got:
            got.update({k: v.detach().float().cpu().numpy()
                        for k, v in g.items()})
        return opt.update(g, opt_state, params)

    grabbing = dataclasses.replace(opt, update=update)
    mesh = loop.train_mesh(cfg, spec)
    strat = loop.setup_strategy(
        cfg, spec, grabbing, create_train_state(spec, opt, seed=cfg.seed,
                                                device=device), mesh,
        fast=False)
    split = mnist.synthesize_split(cfg.batch_size, seed=cfg.seed,
                                   input_size=cfg.input_size)
    rows = mesh_lib.batch_layout(mesh, cfg.batch_size)
    x = torch.from_numpy(split.images[rows]).to(device)
    y = torch.from_numpy(split.labels[rows]).to(device)
    expert = set(transformer.expert_leaves(spec))
    state, times, sent, digests = strat.state, [], 0, []
    for i in range(reps + 1):
        if dist.is_initialized():
            dist.barrier()
        _sync(device)
        for k in mesh_lib.EP_BYTES:
            mesh_lib.EP_BYTES[k] = 0
        t0 = time.perf_counter()
        state = strat.body(state, x, y)[0]
        _sync(device)
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
        sent = sum(mesh_lib.EP_BYTES.values())
        h = hashlib.sha256()
        for k in sorted(state.params):
            if k not in expert:
                h.update(state.params[k].detach().cpu().numpy().tobytes())
        digests.append(h.hexdigest())
    shapes = {w.__name__: w.last_shape
              for w in flash_attention.KERNEL_WRAPPERS}
    del state, strat
    return dict(warm_step_ms=times, step_bytes=sent, digests=digests,
                train_shapes=shapes, grads=got)


def _ep_wire(cfg, device: str) -> dict:
    """What one MoE block's FFN, forward and backward, at ``cfg``'s
    layout moves between the two ranks: the bytes posted to the expert
    axis's exchanges (``EP_BYTES``) and the bytes the loopback device
    carried meanwhile (both ranks' traffic), each window between
    barriers after one untimed block."""
    import torch.distributed as dist

    from distributed_tensorflow_example_tpu_torch import convert
    from distributed_tensorflow_example_tpu_torch.models import transformer
    from distributed_tensorflow_example_tpu_torch.models.mlp import (
        _ACTIVATIONS)
    from distributed_tensorflow_example_tpu_torch.parallel import (
        mesh as mesh_lib)
    from distributed_tensorflow_example_tpu_torch.train import loop

    spec = loop.make_spec(cfg)
    mesh = loop.train_mesh(cfg, spec)
    axis = mesh_lib.expert_axis(mesh)
    z = _ep_sizes(cfg)
    params = convert.expert_shard(transformer.init(
        spec, seed=cfg.seed, device=device), spec, mesh.ep,
        mesh.expert_index)
    bp = {k: v for k, v in transformer._block_params(params, 0).items()
          if k in ("Wr", "We1", "be1", "We2", "be2")}
    del params
    g = torch.Generator(device=device).manual_seed(23 + mesh.rank)
    shape = (z["rows"], cfg.seq_len, cfg.d_model)
    a, cot = (torch.randn(shape, generator=g, device=device)
              for _ in range(2))
    act = _ACTIVATIONS[spec.activation]
    out = {}
    for _ in range(2):
        leaves = {k: v.detach().requires_grad_(True) for k, v in bp.items()}
        x = a.detach().requires_grad_(True)
        dist.barrier()
        for key in mesh_lib.EP_BYTES:
            mesh_lib.EP_BYTES[key] = 0
        before = _lo_bytes()
        dist.barrier()
        y, _aux = transformer._moe_ffn_sparse(
            spec, leaves, x, act, spec.compute_dtype, None, axis)
        torch.autograd.grad(y, [x] + list(leaves.values()), cot)
        _sync(device)
        dist.barrier()
        after = _lo_bytes()
        out = dict(posted=sum(mesh_lib.EP_BYTES.values()),
                   loopback=(None if before is None or after is None
                             else after - before))
    return out


def _b8_last() -> dict:
    """The grouped FFN wrappers' last launches: the training form's
    plan and ``[E, C, d, ff]``, the primal form's shape."""
    from distributed_tensorflow_example_tpu_torch.ops import fused

    z1, primal = fused.moe_grouped_matmul_z1, fused.moe_grouped_matmul
    return dict(z1_plan=getattr(z1, "last_plan", None),
                z1_shape=getattr(z1, "last_shape", None),
                primal_shape=getattr(primal, "last_shape", None))


def ep_child(args: dict, rank: int) -> dict:
    """Phase 5h's rank ``rank`` (of two): a gloo group on the card set up
    here, which ``loop.run`` finds up and leaves; each run of
    ``args["runs"]`` at ``--expert_parallel 2`` with its launch counts
    and B8's last launches, then its warm steps (bytes posted, digests
    of the replicated leaves), on the cuts its first step's gradients
    against the one-rank run's (``args["grads"]``: this rank's experts'
    slice of them), on the wide run one block's traffic."""
    import torch.distributed as dist

    from distributed_tensorflow_example_tpu_torch.parallel import (
        mesh as mesh_lib)
    from distributed_tensorflow_example_tpu_torch.train import loop

    device = args["device"]
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{args['port']}",
        world_size=EP_DEG, rank=rank,
        timeout=datetime.timedelta(seconds=180))
    from distributed_tensorflow_example_tpu_torch.ops import fused

    runs = {}
    for name, entry in args["runs"].items():
        cfg = _ep_cfg(entry, device, EP_DEG)
        for w in (fused.moe_grouped_matmul, fused.moe_grouped_matmul_z1):
            w.last_plan = w.last_shape = None
        m = _tp_run(cfg, f"ep {name} rank {rank}", device, echo=rank == 0)
        m.update(b8=_b8_last(), **_ep_sizes(cfg))
        step = _ep_step(cfg, device, grads=name in EP_CUTS)
        got = step.pop("grads")
        if name in EP_CUTS:
            spec = loop.make_spec(cfg)
            expert = mesh_lib.expert_sharded(spec, EP_DEG)
            with np.load(args["grads"][name]) as z:
                want = {k: (np.array_split(z[k], EP_DEG)[rank]
                            if k in expert else z[k]) for k in z.files}
            step["grad_errs"] = _grad_errs(got, want)
        if name == "ep_wide":
            m["wire"] = _ep_wire(cfg, device)
        runs[name] = dict(m, **step)
        log(f"[ep] rank {rank} {name}: {m['wall_s']:.1f} s on "
            f"{args['card']}")
    dist.barrier()
    dist.destroy_process_group()
    return runs


def check_ep_kernels(card: str) -> list:
    """The kernels at an expert-parallel rank's shapes in phase 5h's
    wide run: B8's training form on the rank's [32, 640, 1024] x 2048
    (its 32 experts, both shards' 320 rows each) against its plain
    version within the Z1 tolerances, timed beside the plain version,
    the ``baddbmm`` chain and its bound; B5's stats form, B6 and B7 on
    the rank's token shard [16, 1024, 8, 128] (causal)."""
    from distributed_tensorflow_example_tpu_torch.models.mlp import (
        _ACTIVATIONS)
    from distributed_tensorflow_example_tpu_torch.ops import fused

    e, c, d, ff, cdt = 32, 640, 1024, 2048, torch.bfloat16
    gelu = _ACTIVATIONS["gelu"]
    g = _gen(17000)
    args = ("gelu", cdt,
            torch.randn(e, c, d, generator=g, device="cuda").to(cdt),
            (torch.randn(e, d, ff, generator=g, device="cuda")
             / d ** 0.5).to(cdt),
            0.1 * torch.randn(e, ff, generator=g, device="cuda"),
            (torch.randn(e, ff, d, generator=g, device="cuda")
             / ff ** 0.5).to(cdt),
            0.1 * torch.randn(e, d, generator=g, device="cuda"))
    out, z1 = fused.moe_grouped_matmul_z1(*args)
    ref_out, ref_z1 = fused.grouped_ffn_reference(*args)
    torch.cuda.synchronize()
    e_out, e_z1 = _errs(out, ref_out), _errs(z1, ref_z1)
    if not (e_out[1] <= Z1_OUT_RTOL and e_z1[1] <= Z1_RTOL):
        raise AssertionError(f"ep kernels: grouped_ffn_z1 [{e}, {c}, {d}]: "
                             f"out {e_out[1]}, z1 {e_z1[1]} of scale")
    del out, z1, ref_out, ref_z1

    def lib(act, cdt_, x_, w1_, b1_, w2_, b2_):
        h = gelu(torch.baddbmm(b1_[:, None].to(cdt_), x_, w1_))
        return torch.baddbmm(b2_[:, None].to(cdt_), h, w2_)

    ms = event_ms(fused.moe_grouped_matmul_z1, args)
    plain_ms = event_ms(fused.grouped_ffn_reference, args)
    library_ms = event_ms(lib, args)
    nbytes = (e * c * d * 2 + 2 * e * d * ff * 2 + e * ff * 4 + e * d * 4
              + e * c * d * 4 + e * c * ff * 4)
    flops = 4 * e * c * d * ff
    bound, by = _bound(nbytes, flops)
    row = dict(kernel="grouped_ffn_z1", path="ep rank", experts=e, rows=c,
               d=d, ff=ff, dtype="bf16", activation="gelu",
               max_abs_err=e_z1[0], rel_err=e_z1[1],
               out_max_abs_err=e_out[0], out_rel_err=e_out[1], ms=ms,
               plain_ms=plain_ms, library_ms=library_ms,
               library_call="baddbmm bf16 + gelu + baddbmm",
               bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops,
               tflops=flops / ms / 1e9, x_library=ms / library_ms,
               **_b8_plan(fused.moe_grouped_matmul_z1.last_plan, e, c, d,
                          ff, z1=True))
    log(f"[ep-kernel] grouped_ffn_z1 [{e}, {c}, {d}] x {ff} bf16: out "
        f"{e_out[1]:.3g} of scale (tol {Z1_OUT_RTOL}), z1 {e_z1[1]:.3g} "
        f"(tol {Z1_RTOL}); kernel {ms:.4f} ms ({row['tflops']:.1f} "
        f"TFLOP/s, {row['x_library']:.2f}x the library), plain "
        f"{plain_ms:.3f} ms, library {library_ms:.4f} ms, bound "
        f"{bound:.4f} ms ({by}); {row['design']}, CTAs per launch "
        f"{row['ctas']} on {card}")
    del args
    torch.cuda.empty_cache()
    return [row] + _flash_form_rows(card, "ep", (
        ("rank token shard", (16, 1024, 8, 128), True),))


def phase_ep(card: str, device: str = "cuda", runs=None,
             timeout: float = 600) -> dict:
    """Expert parallelism at ep 2 on two gloo ranks (phase 5h): each run
    of ``runs`` once at one rank here (no group), then both ranks in
    their own processes (``ep_child``).  Each rank: the devices, steps
    and host path; printed costs within EP_WIDE_COST_RTOL (the wide run)
    or EP_COST_RTOL (the cuts) of the one-rank run's; the bytes a step
    posted to the expert axis equal to the closed form; the replicated
    leaves bitwise equal across the ranks after every step; on the cuts
    the first step's gradients within EP_GRAD_RTOL of the one-rank
    run's; on the card B8's training form launched once a block a step
    at the rank's [El, ep C, d] x ff (none under dense dispatch), B5-B7
    on the rank's token shard, and the loopback's bytes over one wide
    block's exchanges within EP_WIRE_OVER of the bytes the ranks sent
    off their own rank.  Prints each rank's launches, bytes, errors,
    warm step ms (host clock: gloo's host staging), params held and
    peak memory beside the one-rank run's, each line with the card's
    name and power limit."""
    t0 = time.monotonic()
    if device == "cuda":
        card = _card_limit()
    runs = runs or EP_RUNS
    tmp = tempfile.mkdtemp(prefix="dtx-ep-")
    refs, grads = {}, {}
    for name, entry in runs.items():
        cfg = _ep_cfg(entry, device, 1)
        ref = _tp_run(cfg, f"ep {name} one rank", device)
        step = _ep_step(cfg, device, grads=name in EP_CUTS)
        got = step.pop("grads")
        if name in EP_CUTS:
            grads[name] = os.path.join(tmp, f"{name}_grads.npz")
            np.savez(grads[name], **got)
        refs[name] = dict(ref, **step, **_ep_sizes(cfg))
        del got
        if device == "cuda":
            torch.cuda.empty_cache()
        log(f"[ep] {name} one rank: {ref['wall_s']:.1f} s on {card}")
    out = os.path.join(tmp, "ep.json")
    args = json.dumps(dict(device=device, runs=runs, tmp=tmp, out=out,
                           port=_free_port(), card=card, grads=grads))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--ep-phase", args,
         str(r)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=os.path.dirname(os.path.abspath(__file__)))
        for r in range(EP_DEG)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, logs)):
        for line in text.splitlines():
            log(f"  [ep {r}] {line}")
        if p.returncode:
            raise AssertionError(f"ep: rank {r} exited {p.returncode}")
    ranks = []
    for r in range(EP_DEG):
        with open(f"{out}.{r}") as f:
            ranks.append(json.load(f))
    result, faults = {}, []
    for name, entry in runs.items():
        cfg = _ep_cfg(entry, device, EP_DEG)
        ref = refs[name]
        closed = _ep_closed_bytes(cfg)
        mine = [rk[name] for rk in ranks]
        bound = EP_WIDE_COST_RTOL if name == "ep_wide" else EP_COST_RTOL
        for r, m in enumerate(mine):
            if (m["devices"] != EP_DEG or m["steps"] != ref["steps"]
                    or m["fast_loop"]):
                faults.append(f"{name} rank {r}: {m['devices']} devices, "
                              f"{m['steps']} steps, fast_loop "
                              f"{m['fast_loop']}")
            m["cost_rel_err"] = max(abs(a - b) / max(abs(b), 1e-6)
                                    for a, b in zip(m["costs"], ref["costs"]))
            if (len(m["costs"]) != len(ref["costs"])
                    or m["cost_rel_err"] > bound):
                faults.append(f"{name} rank {r}: costs {m['costs']} vs one "
                              f"rank {ref['costs']} (> {bound})")
            m["closed_bytes"] = closed
            if m["step_bytes"] != closed:
                faults.append(f"{name} rank {r}: {m['step_bytes']} B posted "
                              f"a step, closed form {closed}")
            if m["digests"] != mine[0]["digests"]:
                faults.append(f"{name} rank {r}: the replicated leaves "
                              f"differ from rank 0's after a step")
            if name in EP_CUTS:
                m["grad_worst"] = max((e, k) for k, e in
                                      m["grad_errs"].items())
                if not m["grad_worst"][0] <= EP_GRAD_RTOL:
                    faults.append(f"{name} rank {r}: the first step's "
                                  f"gradient {m['grad_worst'][1]} off the "
                                  f"one-rank run's by "
                                  f"{m['grad_worst'][0]:.3g} (> "
                                  f"{EP_GRAD_RTOL})")
            if "wire" in m:
                sent = m["wire"]["posted"] * (EP_DEG - 1) // EP_DEG
                if m["wire"]["posted"] != closed // cfg.num_blocks:
                    faults.append(f"{name} rank {r}: {m['wire']['posted']} "
                                  f"B posted a block, closed form "
                                  f"{closed // cfg.num_blocks}")
                lo = m["wire"]["loopback"]
                if lo is not None and device == "cuda" and not (
                        EP_DEG * sent <= lo <= EP_DEG * sent * EP_WIRE_OVER):
                    faults.append(f"{name} rank {r}: the loopback carried "
                                  f"{lo} B in a block, the ranks sent "
                                  f"{EP_DEG * sent} off their own")
            if device != "cuda":
                continue
            z1 = m["counts"]["moe_grouped_matmul_z1"]
            want = cfg.num_blocks * m["steps"] if m["sparse"] else 0
            if z1 != want:
                faults.append(f"{name} rank {r}: B8's training form "
                              f"launched {z1} times, predicted {want}")
            b8 = [m["el"], EP_DEG * m["cap"], cfg.d_model, cfg.d_ff]
            if m["sparse"] and list(m["b8"]["z1_shape"] or []) != b8:
                faults.append(f"{name} rank {r}: B8 saw "
                              f"{m['b8']['z1_shape']}, predicted {b8}")
            for w in ("flash_forward", "flash_dq", "flash_dkv"):
                if m["counts"][w] <= 0:
                    faults.append(f"{name} rank {r}: {w} never launched")
                want_shape = [m["rows"], cfg.seq_len, cfg.n_heads,
                              cfg.d_model // cfg.n_heads]
                if list(m["train_shapes"][w] or []) != want_shape:
                    faults.append(f"{name} rank {r}: {w} saw "
                                  f"{m['train_shapes'][w]}")
        result[name] = dict(ranks=mine, ref=ref)
        for r, m in enumerate(mine):
            log(f"[ep] {name} rank {r} (ep {EP_DEG}, gloo on one card): "
                f"B8 training form {m['counts']['moe_grouped_matmul_z1']} "
                f"launches (plan {m['b8']['z1_plan']}, last at "
                f"{m['b8']['z1_shape']}), primal form "
                f"{m['counts']['moe_grouped_matmul']} (last at "
                f"{m['b8']['primal_shape']}), B5/B6/B7 "
                f"{m['counts']['flash_forward']}/{m['counts']['flash_dq']}/"
                f"{m['counts']['flash_dkv']} at "
                f"{m['train_shapes']['flash_dq']}, {m['step_bytes']} B "
                f"posted a step to the expert axis (closed form {closed})"
                + (f", one block's exchanges {m['wire']['posted']} B "
                   f"posted and {m['wire']['loopback']} B carried by the "
                   f"loopback for both ranks" if "wire" in m else "")
                + (f", first step's gradient rel L2 err "
                   f"{m['grad_errs']['all']:.3g} (worst leaf "
                   f"{m['grad_worst'][1]} {m['grad_worst'][0]:.3g})"
                   if name in EP_CUTS else "")
                + f", replicated leaves bitwise equal across the ranks "
                f"after each of {len(m['digests'])} steps, warm steps "
                f"{[round(t, 2) for t in m['warm_step_ms']]} ms (host "
                f"clock, gloo's host staging), {m['params_held']} params "
                f"held ({m['expert_params_held']} of the experts), peak "
                f"memory {m['peak_gib']} GiB, costs rel err "
                f"{m['cost_rel_err']:.3g} on {card}")
        log(f"[ep] {name} one rank: warm steps "
            f"{[round(t, 2) for t in ref['warm_step_ms']]} ms, "
            f"{ref['params_held']} params ({ref['expert_params_held']} of "
            f"the experts), peak memory {ref['peak_gib']} GiB, B8 training "
            f"form {ref['counts']['moe_grouped_matmul_z1']} launches on "
            f"{card}")
    if faults:
        raise AssertionError("ep: " + "; ".join(faults))
    shutil.rmtree(tmp, ignore_errors=True)
    kernels = check_ep_kernels(card) if device == "cuda" else []
    log(f"[ep] phase 5h took {time.monotonic() - t0:.1f} s on {card}")
    return dict(runs=result, kernels=kernels)


# ---------------------------------------------------------------------------
# phase 5i: pipeline parallelism on two gloo ranks on the one card
# ---------------------------------------------------------------------------

# two gloo ranks at --pipeline_parallel 2 (dp 1), each in its own process,
# against a one-rank run of the same flags without the stage axis in this
# process (NCCL refuses two ranks on one card; gloo stages every hop
# through host memory, so the step times are gloo's staging, not PP
# across cards).  transformer_wide_long at full width and depth (S 8192,
# 4 blocks, batch 8), 3 steps on the host path (JAX's gate), 4
# microbatches: a microbatch is [2, 8192, 1024], each hop 64 MiB of f32
PP_DEG = 2
PP_MICRO = 4
PP_BASE = WIDE_LONG_FLAGS + ["--no_fast_loop", "--synthetic_train_size=24",
                             f"--microbatches={PP_MICRO}"]
PP_RUNS = {
    "pp_gpipe": PP_BASE,
    "pp_1f1b": PP_BASE + ["--pp_schedule=1f1b"],
    "pp_1f1b_v2": PP_BASE + ["--pp_schedule=1f1b", "--virtual_stages=2"],
}
# each printed cost against the one-rank run's: a microbatch's bf16
# activations round as the whole batch's do, but the f32 sums over the
# microbatches and the stage sum add in another order (phase 5e's bound)
PP_COST_RTOL = TP_COST_RTOL
# the first step's gradients (as the optimizer receives them, each rank's
# stage slice of the stacked leaves against the one-rank run's blocks) in
# relative L2, each leaf and the whole
PP_GRAD_RTOL = 1e-2


def _pp_cfg(entry, device: str, pp: int):
    """A ``PP_RUNS`` entry's config at ``pp`` stages; at one stage the
    same flags without the stage axis (the schedule flags need one)."""
    import dataclasses

    from distributed_tensorflow_example_tpu_torch.config import (
        parse_train_config)

    cfg = dataclasses.replace(parse_train_config(entry), device=device,
                              pipeline_parallel=pp, checkpoint_dir="")
    if pp == 1:
        cfg = dataclasses.replace(cfg, pp_schedule="gpipe",
                                  virtual_stages=1)
    return cfg


def _pp_closed_bytes(cfg, stage: int) -> dict:
    """The bytes stage ``stage`` posts to the stage hops in one training
    step, in closed form: each microbatch leaves each of the stage's v
    chunks for the next stage (forward) but the last stage's last chunk,
    and its gradient leaves each chunk for the previous stage (backward)
    but stage 0's first chunk; a hop is one f32 [mb, S, D].  Summed over
    the stages: M (p v - 1) hops a direction."""
    p, v, m = cfg.pipeline_parallel, cfg.virtual_stages, cfg.microbatches
    hop = (cfg.batch_size // m) * cfg.seq_len * cfg.d_model * 4
    return dict(fwd=hop * m * (v - (stage == p - 1)),
                bwd=hop * m * (v - (stage == 0)))


def _pp_launches(cfg, stage: int, steps: int, eval_chunks: int) -> dict:
    """B2-B7's launches on stage ``stage`` in a run of ``steps`` steps
    and ``eval_chunks`` eval chunks (each split into the microbatches):
    the stage's blocks a microbatch each forward (twice under 1F1B, whose
    backward sub-slot re-runs the slot), B4 and B6/B7 once a microbatch
    in each backward, the final LayerNorm once a microbatch on the last
    stage."""
    m = cfg.microbatches
    k = cfg.num_blocks // cfg.pipeline_parallel
    last = int(stage == cfg.pipeline_parallel - 1)
    fwd = steps * m * (2 if cfg.pp_schedule == "1f1b" else 1)
    evals = eval_chunks * m
    return dict(flash_forward=(fwd + evals) * k, flash_dq=steps * m * k,
                flash_dkv=steps * m * k,
                fused_layer_norm=(fwd + evals) * (k + last),
                fused_layer_norm_residual=(fwd + evals) * k,
                layer_norm_backward=steps * m * (2 * k + last))


def _pp_step(cfg, device: str, reps: int = 2) -> dict:
    """``reps`` warm steps of ``cfg``'s strategy on one synthetic batch
    (after a first step from the seeded init), each between a barrier of
    the group (when one is up) and a sync (host clock: under gloo the
    staged hops' time too); the bytes the last one posted to the stage
    hops (``parallel/mesh.PP_BYTES``); a digest of the replicated leaves
    after every step; the flash wrappers' last shapes (a training
    step's); the peak memory of the steps; and the first step's
    gradients as the optimizer received them (f32 numpy; this stage's
    slice of the stacked leaves)."""
    import dataclasses
    import hashlib

    import torch.distributed as dist

    from distributed_tensorflow_example_tpu_torch.data import mnist
    from distributed_tensorflow_example_tpu_torch.ops import flash_attention
    from distributed_tensorflow_example_tpu_torch.parallel import (
        mesh as mesh_lib)
    from distributed_tensorflow_example_tpu_torch.train import loop, optim
    from distributed_tensorflow_example_tpu_torch.train.state import (
        create_train_state)

    spec = loop.make_spec(cfg)
    opt = optim.make_optimizer(cfg, 8)
    got = {}

    def update(g, opt_state, params):
        if not got:
            got.update({k: v.detach().float().cpu().numpy()
                        for k, v in g.items()})
        return opt.update(g, opt_state, params)

    grabbing = dataclasses.replace(opt, update=update)
    mesh = loop.train_mesh(cfg, spec)
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if device == "cuda" else 0
    strat = loop.setup_strategy(
        cfg, spec, grabbing, create_train_state(spec, opt, seed=cfg.seed,
                                                device=device), mesh,
        fast=False)
    split = mnist.synthesize_split(cfg.batch_size, seed=cfg.seed,
                                   input_size=cfg.input_size)
    rows = mesh_lib.batch_layout(mesh, cfg.batch_size)
    x = torch.from_numpy(split.images[rows]).to(device)
    y = torch.from_numpy(split.labels[rows]).to(device)
    state, times, sent, digests = strat.state, [], {}, []
    for i in range(reps + 1):
        if dist.is_initialized():
            dist.barrier()
        _sync(device)
        for k in mesh_lib.PP_BYTES:
            mesh_lib.PP_BYTES[k] = 0
        t0 = time.perf_counter()
        state = strat.body(state, x, y)[0]
        _sync(device)
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
        sent = dict(mesh_lib.PP_BYTES)
        h = hashlib.sha256()
        for k in sorted(state.params):
            if not k.startswith("blk_"):
                h.update(state.params[k].detach().cpu().numpy().tobytes())
        digests.append(h.hexdigest())
    shapes = {w.__name__: w.last_shape
              for w in flash_attention.KERNEL_WRAPPERS}
    peak = ((torch.cuda.max_memory_allocated() - base) / 2 ** 30
            if device == "cuda" else None)
    del state, strat
    return dict(warm_step_ms=times, step_bytes=sent, digests=digests,
                train_shapes=shapes, step_peak_gib=peak, grads=got)


def pp_child(args: dict, rank: int) -> dict:
    """Phase 5i's rank ``rank`` (of two): a gloo group on the card set up
    here, which ``loop.run`` finds up and leaves; each run of
    ``args["runs"]`` at ``--pipeline_parallel 2`` with its launch
    counts, then its warm steps (bytes posted, digests of the replicated
    leaves, peak memory) and its first step's gradients against this
    stage's slice of the one-rank run's, stacked at the run's (stages,
    virtual)."""
    import torch.distributed as dist

    from distributed_tensorflow_example_tpu_torch import convert
    from distributed_tensorflow_example_tpu_torch.train import loop

    device = args["device"]
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{args['port']}",
        world_size=PP_DEG, rank=rank,
        timeout=datetime.timedelta(seconds=180))
    with np.load(args["grads"]) as z:
        flat = {k: z[k] for k in z.files}
    runs = {}
    for name, entry in args["runs"].items():
        cfg = _pp_cfg(entry, device, PP_DEG)
        m = _tp_run(cfg, f"pp {name} rank {rank}", device, echo=rank == 0)
        step = _pp_step(cfg, device)
        spec = loop.make_spec(cfg)
        want = convert.stack_numpy(flat, spec, PP_DEG, cfg.virtual_stages)
        k = cfg.num_blocks // PP_DEG
        want = {n: (a[rank * k:(rank + 1) * k] if n.startswith("blk_")
                    else a) for n, a in want.items()}
        step["grad_errs"] = _grad_errs(step.pop("grads"), want)
        runs[name] = dict(m, **step)
        log(f"[pp] rank {rank} {name}: {m['wall_s']:.1f} s on "
            f"{args['card']}")
    dist.barrier()
    dist.destroy_process_group()
    return runs


def check_pp_kernels(card: str) -> list:
    """B5's stats form, B6 and B7 at a pipeline microbatch's [2, 8192, 8,
    128] (causal), against their plain versions, timed beside SDPA and
    the bound."""
    return _flash_form_rows(card, "pp", (
        ("microbatch", (2, 8192, 8, 128), True),))


def phase_pp(card: str, device: str = "cuda", runs=None,
             timeout: float = 600) -> dict:
    """Pipeline parallelism at pp 2 on two gloo ranks (phase 5i): the
    one-rank run of the same flags without the stage axis here (no
    group), then both ranks in their own processes (``pp_child``) under
    each schedule of ``runs``.  Each rank: the devices, steps and host
    path; printed costs within PP_COST_RTOL of the one-rank run's; the
    bytes a step posted to the stage hops equal to the closed form
    (``_pp_closed_bytes``); the replicated leaves bitwise equal across
    the ranks after every step; the first step's gradients within
    PP_GRAD_RTOL of the one-rank run's, each leaf and the whole; on the
    card B2-B7 launched exactly as ``_pp_launches`` predicts and B5-B7
    at the microbatch's shape.  Prints each rank's launches, bytes (the
    split by rank), errors, warm step ms (host clock: gloo's staging,
    not PP across cards) and peak memory (the run's and the steps')
    beside the one-rank run's, each line with the card's name and power
    limit; then B5-B7 at the microbatch shape against their plain
    versions (``check_pp_kernels``)."""
    from distributed_tensorflow_example_tpu_torch.parallel import (
        step as step_lib)
    from distributed_tensorflow_example_tpu_torch.train import loop

    t0 = time.monotonic()
    if device == "cuda":
        card = _card_limit()
    runs = runs or PP_RUNS
    tmp = tempfile.mkdtemp(prefix="dtx-pp-")
    ref_cfg = _pp_cfg(next(iter(runs.values())), device, 1)
    ref = _tp_run(ref_cfg, "pp one rank", device)
    step = _pp_step(ref_cfg, device)
    grads = os.path.join(tmp, "one_rank_grads.npz")
    np.savez(grads, **step.pop("grads"))
    ref.update(step)
    if device == "cuda":
        torch.cuda.empty_cache()
    log(f"[pp] one-rank run: {ref['wall_s']:.1f} s on {card}")
    out = os.path.join(tmp, "pp.json")
    args = json.dumps(dict(device=device, runs=runs, tmp=tmp, out=out,
                           port=_free_port(), card=card, grads=grads))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--pp-phase", args,
         str(r)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=os.path.dirname(os.path.abspath(__file__)))
        for r in range(PP_DEG)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, logs)):
        for line in text.splitlines():
            log(f"  [pp {r}] {line}")
        if p.returncode:
            raise AssertionError(f"pp: rank {r} exited {p.returncode}")
    ranks = []
    for r in range(PP_DEG):
        with open(f"{out}.{r}") as f:
            ranks.append(json.load(f))
    result, faults = {}, []
    for name, entry in runs.items():
        cfg = _pp_cfg(entry, device, PP_DEG)
        mine = [rk[name] for rk in ranks]
        mb = cfg.batch_size // cfg.microbatches
        shape = [mb, cfg.seq_len, cfg.n_heads, cfg.d_model // cfg.n_heads]
        # the trainer's eval chunks: rounded to the batch shards (1) x
        # the microbatches
        n_test, unit = cfg.synthetic_test_size, cfg.microbatches
        cap = step_lib.eval_chunk_cap(loop.make_spec(cfg),
                                      cfg.eval_batch_size)
        chunk = max(unit, (min(max(cap, unit), n_test) // unit) * unit)
        eval_chunks = -(-n_test // chunk)
        for r, m in enumerate(mine):
            if (m["devices"] != PP_DEG or m["steps"] != ref["steps"]
                    or m["fast_loop"]):
                faults.append(f"{name} rank {r}: {m['devices']} devices, "
                              f"{m['steps']} steps, fast_loop "
                              f"{m['fast_loop']}")
            m["cost_rel_err"] = max(abs(a - b) / max(abs(b), 1e-6)
                                    for a, b in zip(m["costs"], ref["costs"]))
            if (len(m["costs"]) != len(ref["costs"])
                    or m["cost_rel_err"] > PP_COST_RTOL):
                faults.append(f"{name} rank {r}: costs {m['costs']} vs one "
                              f"rank {ref['costs']} (> {PP_COST_RTOL})")
            m["closed_bytes"] = _pp_closed_bytes(cfg, r)
            if m["step_bytes"] != m["closed_bytes"]:
                faults.append(f"{name} rank {r}: {m['step_bytes']} B posted "
                              f"a step, closed form {m['closed_bytes']}")
            if m["digests"] != mine[0]["digests"]:
                faults.append(f"{name} rank {r}: the replicated leaves "
                              f"differ from rank 0's after a step")
            m["grad_worst"] = max((e, k) for k, e in m["grad_errs"].items())
            if not m["grad_worst"][0] <= PP_GRAD_RTOL:
                faults.append(f"{name} rank {r}: the first step's gradient "
                              f"{m['grad_worst'][1]} off the one-rank run's "
                              f"by {m['grad_worst'][0]:.3g} (> "
                              f"{PP_GRAD_RTOL})")
            m["predicted"] = _pp_launches(cfg, r, m["steps"], eval_chunks)
            if device != "cuda":
                continue
            for w, n in m["predicted"].items():
                if m["counts"][w] != n:
                    faults.append(f"{name} rank {r}: {w} launched "
                                  f"{m['counts'][w]} times, predicted {n}")
            for w in ("flash_forward", "flash_dq", "flash_dkv"):
                if list(m["train_shapes"][w] or []) != shape:
                    faults.append(f"{name} rank {r}: {w} saw "
                                  f"{m['train_shapes'][w]}, predicted "
                                  f"{shape}")
        result[name] = dict(ranks=mine)
        for r, m in enumerate(mine):
            c = m["counts"]
            log(f"[pp] {name} rank {r} (stage {r} of {PP_DEG}, gloo on one "
                f"card): B2/B3/B4 {c['fused_layer_norm']}/"
                f"{c['fused_layer_norm_residual']}/"
                f"{c['layer_norm_backward']}, B5/B6/B7 "
                f"{c['flash_forward']}/{c['flash_dq']}/{c['flash_dkv']} "
                f"(predicted {m['predicted']}) at "
                f"{m['train_shapes']['flash_dq']}, hops a step "
                f"{m['step_bytes']} B posted (closed form "
                f"{m['closed_bytes']}), first step's gradient rel L2 err "
                f"{m['grad_errs']['all']:.3g} (worst leaf "
                f"{m['grad_worst'][1]} {m['grad_worst'][0]:.3g}), "
                f"replicated leaves bitwise equal across the ranks after "
                f"each of {len(m['digests'])} steps, warm steps "
                f"{[round(t, 2) for t in m['warm_step_ms']]} ms (host "
                f"clock: gloo's host staging, not PP across cards), peak "
                f"memory {m['peak_gib']} GiB a run, {m['step_peak_gib']} "
                f"GiB over the steps, costs rel err "
                f"{m['cost_rel_err']:.3g} on {card}")
    log(f"[pp] one rank: warm steps "
        f"{[round(t, 2) for t in ref['warm_step_ms']]} ms, peak memory "
        f"{ref['peak_gib']} GiB a run, {ref['step_peak_gib']} GiB over the "
        f"steps, B2-B4 {ref['counts']['fused_layer_norm']}/"
        f"{ref['counts']['fused_layer_norm_residual']}/"
        f"{ref['counts']['layer_norm_backward']}, B5/B6/B7 "
        f"{ref['counts']['flash_forward']}/{ref['counts']['flash_dq']}/"
        f"{ref['counts']['flash_dkv']} on {card}")
    if faults:
        raise AssertionError("pp: " + "; ".join(faults))
    shutil.rmtree(tmp, ignore_errors=True)
    kernels = check_pp_kernels(card) if device == "cuda" else []
    log(f"[pp] phase 5i took {time.monotonic() - t0:.1f} s on {card}")
    return dict(runs=result, ref=ref, kernels=kernels)


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


def phase_transformer_train(card: str, flags=WIDE_LONG_FLAGS,
                            tag: str = "tfm-train") -> dict:
    """The transformer trainer at the ``transformer_wide_long`` width
    (WIDE_LONG_FLAGS, parsed as the CLI parses them) on the card; phase
    7c passes WIDE_HEAD_FLAGS.  B6 and B7 must run at the training
    batch's [B, S, H, D], B5 last at the eval chunk's."""
    from distributed_tensorflow_example_tpu_torch.config import (
        parse_train_config)
    from distributed_tensorflow_example_tpu_torch.models import (
        transformer as tfm)
    from distributed_tensorflow_example_tpu_torch.ops import fused
    from distributed_tensorflow_example_tpu_torch.ops import (
        flash_attention as fa)
    from distributed_tensorflow_example_tpu_torch.parallel import step
    from distributed_tensorflow_example_tpu_torch.train import loop

    cfg = parse_train_config(flags)
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
    heads = (spec.seq_len, spec.n_heads, spec.d_model // spec.n_heads)
    # the fast path's eval chunk (parallel/epoch.build_fast_eval, dp 1)
    n_test = cfg.synthetic_test_size
    chunk = min(step.eval_chunk_cap(spec, n_test), n_test)
    shapes = {w.__name__: w.last_shape for w in fa.KERNEL_WRAPPERS}
    want_shapes = {"flash_forward": (chunk, *heads),
                   "flash_dq": (cfg.batch_size, *heads),
                   "flash_dkv": (cfg.batch_size, *heads)}
    if shapes != want_shapes:
        raise AssertionError(f"transformer train: flash shapes {shapes}, "
                             f"expected {want_shapes}")
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
               total_s=res["total_time_s"], counts=counts, shapes=shapes)
    log(f"[{tag}] transformer_wide_long at {spec.n_heads} heads of "
        f"{heads[2]}, {steps} steps of batch "
        f"{cfg.batch_size} x S {spec.seq_len} on {card}: median step "
        f"{med:.1f} ms, {row['tokens_per_s']:.0f} tokens/s, "
        f"{row['model_tflops_per_s']:.2f} model TFLOP/s "
        f"({flops / 1e12:.2f} TFLOP/step), peak memory {peak_gib:.2f} GiB; "
        f"steps {step_ms} ms; whole run incl. eval {res['total_time_s']:.2f}"
        f" s; launches {counts} at {shapes}; the device-resident epoch "
        f"after a warm one: {epoch_ms:.2f} ms a step")
    return row


def phase_transformer_step(card: str, flags=STEP_CHECK_FLAGS,
                           tag: str = "tfm-step") -> dict:
    """One step of the full-width transformer cut to 1 block, S 2048,
    batch 2 (STEP_CHECK_FLAGS; phase 7d WIDE_HEAD_STEP_FLAGS) from one
    initial state on the card and on the port's CPU path."""
    from distributed_tensorflow_example_tpu_torch.config import (
        parse_train_config)
    from distributed_tensorflow_example_tpu_torch.data import mnist
    from distributed_tensorflow_example_tpu_torch.parallel import step
    from distributed_tensorflow_example_tpu_torch.train import loop, optim
    from distributed_tensorflow_example_tpu_torch.train.state import (
        TrainState, create_train_state)

    cfg = parse_train_config(flags)
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
    log(f"[{tag}] one step (1 block, S {spec.seq_len}, batch "
        f"{cfg.batch_size}, d_model {spec.d_model}, {spec.n_heads} heads of "
        f"{spec.d_model // spec.n_heads}) card vs CPU path: cost "
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
        # the card's step under a profiler window (phase 7e (c)): the
        # MoE scopes, and B8's training form launched inside moe_expert
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            new_card, cost_card, _ = body(on_card, x.cuda(), y.cuda())
            torch.cuda.synchronize()
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
    with tempfile.TemporaryDirectory() as d:
        prof.export_chrome_trace(os.path.join(d, "moe.json"))
        with open(os.path.join(d, "moe.json")) as f:
            events = json.load(f)["traceEvents"]
    scopes = {n: sum(1 for e in events if e.get("name") == n
                     and e.get("cat") == "user_annotation")
              for n in ("moe_dispatch", "moe_expert")}
    inside = sorted(set(_scope_kernels(events, "moe_expert")))
    b8 = [k for k in inside if "gemm_bias_act_tc_kernel" in k]
    log(f"[moe-step] 7e (c) the card's step under a profiler window: "
        f"ranges {scopes}; kernels launched inside moe_expert "
        f"{[k[:60] for k in inside]} on {card}")
    if not all(scopes.values()) or not b8:
        raise AssertionError(f"moe step: ranges {scopes}, no B8 kernel "
                             f"inside moe_expert ({inside})")
    log(f"[moe-step] one step (1 block, E {spec.num_experts}, S "
        f"{spec.seq_len}, batch {cfg.batch_size}, d_model {spec.d_model}, "
        f"aux weight {spec.aux_loss_weight}) card vs CPU path: cost "
        f"{float(cost_card):.6g} vs {float(cost_cpu):.6g}, worst update "
        f"difference {worst:.3g} of its scale (tol {MOE_STEP_RTOL}); CPU "
        f"step {cpu_s:.1f} s")
    return dict(worst=worst, flips=flips[0], dropped=dropped,
                scopes=scopes, b8_in_expert=len(b8))


# phase 7e: the trainer's last outputs.  (a) --sample_after sharded over
# the data axis (generate_dp) on two gloo ranks on the one card, after a
# 2-step run at the serving model's widths under --attention=flash
# --fused_ln (global batch 8): 8 greedy prompts, 4 a rank
SAMPLE_FLAGS = [
    "--model=transformer", "--objective=lm", "--input_size=1024",
    "--vocab_size=256", "--d_model=1024", "--n_heads=8", "--num_blocks=4",
    "--d_ff=4096", "--activation=gelu", "--compute_dtype=bfloat16",
    "--attention=flash", "--fused_ln", "--optimizer=adam",
    "--learning_rate=1e-3", "--batch_size=8", "--dataset=synthetic",
    "--synthetic_train_size=16", "--synthetic_test_size=8",
    "--no_summaries", "--frequency=1", "--training_epochs=1",
    "--sample_after=8", "--sample_temperature=0", "--seed=0"]
SAMPLE_DP = 2
# the named scopes' cost: rounds of scopes on and off, interleaved
SCOPE_ROUNDS = 3


@contextlib.contextmanager
def _scopes_as(way: str):
    """``obs/tracer.scope`` while inside (every site looks it up on the
    module): ``"shipped"`` as it is (ranges only inside a profiler
    capture), ``"open"`` its two ranges always open, ``"none"`` no
    range at all."""
    from distributed_tensorflow_example_tpu_torch.obs import tracer

    real = tracer.scope
    if way == "open":
        tracer.scope = tracer._named_range
    elif way == "none":
        tracer.scope = lambda name: contextlib.nullcontext()
    try:
        yield
    finally:
        tracer.scope = real


def _range_us(make, n: int = 20000) -> float:
    """The host microseconds of one empty ``with make():`` block."""
    t0 = time.perf_counter()
    for _ in range(n):
        with make():
            pass
    return (time.perf_counter() - t0) / n * 1e6


def phase_serve_scopes(card: str, base: dict, rounds: int = SCOPE_ROUNDS,
                       device: str = "cuda") -> dict:
    """Phase 7e (d): phase 3's serve under a ``torch.profiler`` window
    names ``prefill``, ``decode``, ``sampling`` and ``ln``; the named
    scopes' cost: the same serve with the scopes as shipped (no range
    outside a capture), with their ranges always open, and with no
    scope at all, interleaved over ``rounds`` rounds (each run's median
    decode tick), and the host microseconds of one empty scope outside
    a capture, and of one ``record_function`` and one NVTX range alone.
    Printed, not gated."""
    from torch.profiler import ProfilerActivity, profile

    from distributed_tensorflow_example_tpu_torch.obs import tracer
    from distributed_tensorflow_example_tpu_torch.obs.buckets import (
        NAMED_SCOPES)

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device == "cuda" else [])
    with profile(activities=acts) as prof:
        run = serve_run(base["spec"], base["params"], device)
    seen = {}
    for e in prof.events():
        if e.name in NAMED_SCOPES:
            seen[e.name] = seen.get(e.name, 0) + 1
    if not {"prefill", "decode", "sampling", "ln"} <= set(seen):
        raise AssertionError(f"serve scopes: the window names {seen}")
    ways = ("shipped", "open", "none")
    ticks = {w: [] for w in ways}
    for r in range(rounds):
        for way in (ways if r % 2 == 0 else ways[::-1]):
            with _scopes_as(way):
                ticks[way].append(serve_run(base["spec"], base["params"],
                                            device)["tick_ms"])
    us = dict(scope=_range_us(lambda: tracer.scope("ln")),
              record_function=_range_us(
                  lambda: torch.profiler.record_function("ln")),
              nvtx=(_range_us(lambda: torch.cuda.nvtx.range("ln"))
                    if device == "cuda" else None))
    med = {w: statistics.median(t) for w, t in ticks.items()}
    out = dict(ranges=seen, ranges_per_tick=sum(seen.values()) / run["ticks"],
               tick_ms=med, ticks=ticks, us=us)
    log(f"[scopes] 7e (d) phase 3's serve under a profiler window: ranges "
        f"{seen} over {run['ticks']} ticks ({out['ranges_per_tick']:.2f} a "
        f"tick); decode tick ms, {rounds} interleaved rounds: scopes as "
        f"shipped {ticks['shipped']}, ranges always open {ticks['open']}, "
        f"no scopes {ticks['none']}, medians {med}; one empty scope outside"
        f" a capture {us['scope']:.3f} us, record_function alone "
        f"{us['record_function']:.3f}, NVTX alone {us['nvtx']} on "
        f"{_card_limit() if device == 'cuda' else card}")
    return out


def sample_child(args: dict, rank: int) -> dict:
    """Phase 7e (a)'s rank ``rank`` (of two): a gloo group on the card,
    which ``loop.run`` finds up and leaves; the SAMPLE_FLAGS run with the
    launch counts zeroed just before and read just after, its decode
    (``generate`` inside ``generate_dp``) timed, then the same rows
    decoded again by this rank alone at the same batch; rank 0 also
    decodes all the prompts at once, for the wall."""
    import dataclasses

    import torch.distributed as dist

    from distributed_tensorflow_example_tpu_torch.config import (
        parse_train_config)
    from distributed_tensorflow_example_tpu_torch.models import (
        transformer as tfm)
    from distributed_tensorflow_example_tpu_torch.ops import fused
    from distributed_tensorflow_example_tpu_torch.train import loop

    device = args["device"]
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{args['port']}",
        world_size=SAMPLE_DP, rank=rank,
        timeout=datetime.timedelta(seconds=120))
    cfg = dataclasses.replace(parse_train_config(args["flags"]),
                              device=device)
    seen = {}
    real_dp, real_gen = tfm.generate_dp, tfm.generate

    def generate_dp(spec, params, prompts, mesh, **kw):
        seen.update(spec=spec, params=params, prompts=prompts)
        return real_dp(spec, params, prompts, mesh, **kw)

    def generate(spec, params, prompt, **kw):
        _sync(device)
        t0 = time.perf_counter()
        out = real_gen(spec, params, prompt, **kw)
        _sync(device)
        seen.update(rows=prompt, tokens=out,
                    ms=(time.perf_counter() - t0) * 1e3)
        return out

    tfm.generate_dp, tfm.generate = generate_dp, generate
    tfm.DP_SAMPLE_BYTES["all_gather"] = 0
    fused.reset_launch_counts()
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = loop.run(cfg)
    finally:
        tfm.generate_dp, tfm.generate = real_dp, real_gen
    _sync(device)
    counts = fused.launch_counts()
    # the graph dump's first arming in a trainer process (its dispatch
    # mode's first use), which a --profile run pays once
    from distributed_tensorflow_example_tpu_torch.utils import graph

    t0 = time.perf_counter()
    graph.GraphDump(os.path.dirname(args["out"]))
    arm_ms = (time.perf_counter() - t0) * 1e3
    again = real_gen(seen["spec"], seen["params"], seen["rows"])
    out = dict(rows=int(seen["rows"].shape[0]), decode_ms=seen["ms"],
               equal=bool(torch.equal(again, seen["tokens"])),
               tokens=seen["tokens"].cpu().tolist(), counts=counts,
               gather_bytes=tfm.DP_SAMPLE_BYTES["all_gather"],
               steps=res["steps"], stdout=buf.getvalue(),
               seq_len=seen["spec"].seq_len, dump_arm_ms=arm_ms)
    if rank == 0:
        _sync(device)
        t0 = time.perf_counter()
        real_gen(seen["spec"], seen["params"], seen["prompts"])
        _sync(device)
        out["all_ms"] = (time.perf_counter() - t0) * 1e3
        out["prompts"] = int(seen["prompts"].shape[0])
    dist.barrier()
    dist.destroy_process_group()
    return out


def _sample_phase(card: str, device: str, timeout: float,
                  flags=SAMPLE_FLAGS) -> dict:
    """Phase 7e (a): the two ranks of ``sample_child``; each decoded the
    4 rows of its data index, equal to its own one-rank decode of them,
    the chief's ``samples.npz`` holds the 8 rows gathered in data-index
    order, and B2-B7 launched in every rank."""
    tmp = tempfile.mkdtemp(prefix="dtx-sample-")
    out = os.path.join(tmp, "sample.json")
    args = json.dumps(dict(device=device, out=out, port=_free_port(),
                           flags=list(flags) + [f"--logs_path={tmp}/logs"]))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--sample-phase", args,
         str(r)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=os.path.dirname(os.path.abspath(__file__)))
        for r in range(SAMPLE_DP)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, logs)):
        for line in text.splitlines():
            log(f"  [sample {r}] {line}")
        if p.returncode:
            raise AssertionError(f"sample: rank {r} exited {p.returncode}")
    ranks = []
    for r in range(SAMPLE_DP):
        with open(f"{out}.{r}") as f:
            ranks.append(json.load(f))
    for line in ranks[0].pop("stdout").splitlines():
        log(f"  | {line}")
    with np.load(os.path.join(tmp, "logs", "samples.npz")) as z:
        samples = z["samples"]
    shutil.rmtree(tmp, ignore_errors=True)
    n, rows = ranks[0]["prompts"], ranks[0]["prompts"] // SAMPLE_DP
    faults = []
    if samples.shape != (n, ranks[0]["seq_len"]) or n != 8:
        faults.append(f"samples.npz holds {samples.shape}")
    for r, m in enumerate(ranks):
        if m["rows"] != rows or not m["equal"]:
            faults.append(f"rank {r} decoded {m['rows']} rows, equal to "
                          f"its own decode of them: {m['equal']}")
        if not np.array_equal(samples[r * rows:(r + 1) * rows],
                              np.asarray(m["tokens"], np.int32)):
            faults.append(f"rank {r}'s rows differ in samples.npz")
        for w in TFM_WRAPPERS:
            if device == "cuda" and m["counts"][w] <= 0:
                faults.append(f"rank {r}: {w} never launched")
    if faults:
        raise AssertionError("sample: " + "; ".join(faults))
    log(f"[sample] 7e (a) --sample_after={n} greedy over {SAMPLE_DP} gloo "
        f"ranks at the serving widths: rank decodes of {rows} rows "
        f"{[round(m['decode_ms'], 1) for m in ranks]} ms (both ranks on "
        f"the one card at once), one rank's decode of all {n} "
        f"{ranks[0]['all_ms']:.1f} ms; each rank's rows equal its own "
        f"decode at batch {rows}; the gather posted "
        f"{[m['gather_bytes'] for m in ranks]} B a rank (n_pad x seq_len "
        f"x 4 = {n * ranks[0]['seq_len'] * 4}); the graph dump's first "
        f"arming in each rank's process "
        f"{[round(m['dump_arm_ms'], 1) for m in ranks]} ms; launches "
        f"{[m['counts'] for m in ranks]} on "
        f"{_card_limit() if device == 'cuda' else card}")
    return dict(ranks=ranks, all_ms=ranks[0]["all_ms"])


def _dump_phase(card: str, monitoring: dict, device: str,
                rounds: int = SCOPE_ROUNDS, tfm_flags=WIDE_LONG_FLAGS,
                mlp_fields=WIDE_TRAIN) -> dict:
    """Phase 7e (b): one ``transformer_wide_long`` step (the fast path's
    body) after a warm one, timed three ways in interleaved rounds:
    plain, recorded by the graph dump (``utils/graph.GraphDump``) and
    with the named scopes off; the dump's kernel lines equal that
    step's launches and phase 5c's in-run dump's.  Then the MLP's
    captured epoch (WIDE_TRAIN) under ``--profile``: its
    ``train_step.cudagraph.dot`` names B1's kernel."""
    import dataclasses

    from distributed_tensorflow_example_tpu_torch.config import (
        Config, parse_train_config)
    from distributed_tensorflow_example_tpu_torch.data import mnist
    from distributed_tensorflow_example_tpu_torch.ops import fused
    from distributed_tensorflow_example_tpu_torch.parallel import step
    from distributed_tensorflow_example_tpu_torch.train import loop, optim
    from distributed_tensorflow_example_tpu_torch.train.state import (
        create_train_state)
    from distributed_tensorflow_example_tpu_torch.utils import graph

    tmp = tempfile.mkdtemp(prefix="dtx-dump-")
    cfg = dataclasses.replace(parse_train_config(tfm_flags), device=device)
    spec = loop.make_spec(cfg)
    opt = optim.make_optimizer(cfg, 8)
    body = step.make_sync_step_body(cfg, spec, opt)
    split = mnist.synthesize_split(cfg.batch_size, seed=cfg.seed,
                                   input_size=cfg.input_size)
    x = torch.from_numpy(split.images).to(device)
    y = torch.from_numpy(split.labels).to(device)
    state = [create_train_state(spec, opt, seed=cfg.seed, device=device)]
    # armed before the timed steps (arming's one-time cost is sample
    # phase's to measure)
    armed = [graph.GraphDump(os.path.join(tmp, str(i)))
             for i in range(rounds)]
    dumps = []

    def plain():
        return body(state[0], x, y)

    def dumped():
        dumps.append(armed.pop())
        return dumps[-1].record(body, state[0], x, y)

    def unscoped():
        with _scopes_as("none"):
            return body(state[0], x, y)

    ways = {"plain": plain, "dump": dumped, "scopes_off": unscoped}
    times = {k: {"host": [], "wall": []} for k in ways}
    counts = []
    state[0] = plain()[0]
    for r in range(rounds):
        for name in (list(ways) if r % 2 == 0 else list(ways)[::-1]):
            _sync(device)
            fused.reset_launch_counts()
            t0 = time.perf_counter()
            state[0] = ways[name]()[0]
            host = time.perf_counter() - t0
            _sync(device)
            times[name]["host"].append(host * 1e3)
            times[name]["wall"].append((time.perf_counter() - t0) * 1e3)
            if name == "dump":
                counts.append({k: v for k, v in fused.launch_counts().items()
                               if v})
    del state[0]
    if device == "cuda":
        torch.cuda.empty_cache()
    med = {k: {t: statistics.median(v) for t, v in d.items()}
           for k, d in times.items()}
    in_run = monitoring["tfm_dump"]["kernels"]
    faults = [f"dump {i}: kernel lines {d.launches}, launches {c}"
              for i, (d, c) in enumerate(zip(dumps, counts))
              if d.launches != c or not d.paths]
    if device == "cuda" and in_run != counts[0]:
        faults.append(f"phase 5c's in-run dump: kernel lines {in_run}, one "
                      f"step's launches {counts[0]}")
    # the MLP's captured epoch under --profile: the graph's debug dump
    mlp = Config(**dict(mlp_fields, hidden_sizes=tuple(
        mlp_fields["hidden_sizes"])), device=device, profile=True,
        logs_path=os.path.join(tmp, "mlp"))
    fused.reset_launch_counts()
    res, out = _run_captured(loop.run, mlp)
    dot = os.path.join(tmp, "mlp", "train_step.cudagraph.dot")
    text = ""
    if os.path.exists(dot):
        with open(dot) as f:
            text = f.read()
    with open(os.path.join(tmp, "mlp", "train_step.aten.txt")) as f:
        b1_lines = sum(1 for ln in f if ln.startswith("KERNEL mlp_forward("))
    if device == "cuda" and ("gemm_bias_act_tc_kernel" not in text
                             or b1_lines != 1 or not res["fast_loop"]):
        faults.append(f"the MLP's captured epoch: {dot} "
                      f"{'written' if text else 'missing'} "
                      f"({len(text)} bytes), B1 kernel lines {b1_lines}")
    shutil.rmtree(tmp, ignore_errors=True)
    if faults:
        raise AssertionError("graph dump: " + "; ".join(faults))
    log(f"[dump] 7e (b) transformer_wide_long's step, {rounds} interleaved "
        f"rounds, host ms to return / wall ms to the card's end: plain "
        f"{times['plain']}, recorded by the graph dump {times['dump']}, "
        f"named scopes off {times['scopes_off']}; medians {med}; the "
        f"dump's kernel lines {counts[0]} (phase 5c's in-run dump "
        f"{in_run}); the MLP's captured epoch under --profile: "
        f"train_step.cudagraph.dot {len(text)} bytes naming B1's kernel, "
        f"{b1_lines} B1 line in train_step.aten.txt on "
        f"{_card_limit() if device == 'cuda' else card}")
    return dict(times=times, medians=med, kernels=counts[0],
                dot_bytes=len(text))


def phase_last_outputs(card: str, monitoring: dict, device: str = "cuda",
                       timeout: float = 600) -> dict:
    """Phase 7e, the trainer's last outputs: (a) ``--sample_after``
    sharded over the data axis (``_sample_phase``), (b) the graph dump
    and the named scopes' cost on the transformer step
    (``_dump_phase``); (c) is phase 8b's profiler window, (d)
    ``phase_serve_scopes`` and (e) phase 5d's ``fsdp_nans`` run."""
    t0 = time.monotonic()
    out = dict(sample=_sample_phase(card, device, timeout),
               dump=_dump_phase(card, monitoring, device))
    log(f"[7e] phases 7e (a) and (b) took {time.monotonic() - t0:.1f} s")
    return out


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


# phase 9: the two monitoring runs dtx-obs compare holds against each
# other (the wide MLP's graph path, transformer_wide_long) and the one
# threshold it gates them on, JAX's default for the step-time median;
# every other metric's threshold is set out of reach, so the verdict is
# the step-time medians' alone
OBS_COMPARE = ("mon", "tfm")
OBS_STEP_THRESHOLD = 0.05
# the fleet and chaos phases ran without latency objectives: their
# fleet reports are held to exactly-once and the error budget
OBS_FLEET_SPEC = "error_rate<=0.01"


class _ServeStop:
    """The CLI module's ``time`` while ``dtx-obs serve`` runs in a thread:
    ``sleep`` waits on ``event`` and raises KeyboardInterrupt, as ^C does,
    once it is set."""

    def __init__(self):
        self.event = threading.Event()

    def sleep(self, seconds: float) -> None:
        if self.event.wait(seconds):
            raise KeyboardInterrupt


def _obs_serve(logs: str, paths) -> tuple:
    """``dtx-obs serve LOGS`` on a free port in a thread: GET each of
    ``paths`` once it answers, then stop it as ^C would.  Returns (exit
    code, [(path, code, body)])."""
    from distributed_tensorflow_example_tpu_torch.obs import cli

    port, stop, box = _free_port(), _ServeStop(), {}
    argv = ["serve", logs, "--host", "127.0.0.1", "--port", str(port)]
    thread = threading.Thread(
        target=lambda: box.update(rc=cli.main(argv)), daemon=True)
    real_time, cli.time = cli.time, stop
    answers = []
    try:
        thread.start()
        deadline = time.monotonic() + 30
        while True:
            try:
                _get_text(port, "/status")
                break
            except OSError:
                if time.monotonic() > deadline or not thread.is_alive():
                    raise AssertionError(f"dtx-obs serve on port {port} "
                                         f"never answered")
                time.sleep(0.05)
        for path in paths:
            answers.append((path,) + _get_text(port, path))
    finally:
        stop.event.set()
        thread.join(timeout=30)
        cli.time = real_time
    if thread.is_alive():
        raise AssertionError("dtx-obs serve did not stop on ^C")
    return box.get("rc"), answers


def phase_obs(card: str, root: str, spec, replay: dict,
              flags=FULL_WIDTH_FLAGS, device: str = "cuda") -> dict:
    """The port's ``dtx-obs`` (phase 9) over the streams this smoke kept
    under ``root`` (``_keep``: phases 4b, 4d-4g and 5c), each subcommand
    through ``obs.cli.main(argv)`` in process with its exit code checked,
    then ``root`` removed:

    - ``validate`` over every kept run directory and the workload: 0;
    - ``report --summary`` of the monitored MLP run: 0, MFU in (0, 1];
      ``report -o`` of each monitoring run and of the status phase's;
    - ``tail`` of the monitored run: one line per window row;
    - ``compare`` of OBS_COMPARE's two runs both ways (every threshold
      but the step-time median's out of reach): exit 3 where the
      candidate's median is more than OBS_STEP_THRESHOLD slower by the
      medians this phase reads off the rows, 0 the other way;
    - ``slo`` (TRACE_SLO), ``trace 0`` and ``trace --export chrome`` of the
      traced serve: the exit code the breaches imply, the record's
      terminal, the Chrome JSON naming every request of the run;
    - ``explain`` and ``explain --fleet`` of the first replay;
    - ``collect`` and ``fleet`` (OBS_FLEET_SPEC) of the fleet and chaos
      runs: 0, exactly-once;
    - ``capture`` of the first replay, then ``capacity`` at its measured
      tokens/s and completed requests a second: the exit code the
      verdict implies; the forecast, the roofline ceiling of
      ``obs/capacity`` (the card's HBM peak over the decode bytes a
      step) and the measured tokens/s printed;
    - ``history --append`` of the five run reports, ``history``,
      ``drift`` (the exit code its verdict implies) and ``drift
      --capture``: the card's HBM peak in the roofline join;
    - ``serve`` of the monitored run: /status, /metrics and /report 200,
      and the server stopped.

    Prints an ``[obs]`` line a subcommand (exit code, wall, the card's
    name and power limit) and the phase's wall.  On the CPU (a rehearsal
    over narrow runs, ``device="cpu"``) MFU and the HBM peak are null
    and not checked."""
    from distributed_tensorflow_example_tpu_torch.obs import (
        capacity, cli, flops, metrics, spans)

    on_card = device == "cuda"
    smi = _card_limit() if on_card else "the CPU (rehearsal)"
    t_phase = time.monotonic()
    ran = []

    def run(argv, want=None):
        out, err = io.StringIO(), io.StringIO()
        t0 = time.monotonic()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(argv)
        wall = time.monotonic() - t0
        ran.append((argv[0], rc, wall))
        shown = " ".join(a.replace(root, "$KEPT") for a in argv)
        log(f"[obs] dtx-obs {shown[:200]}: rc {rc} in {wall:.4f} s on {smi}")
        if want is not None and rc != want:
            raise AssertionError(f"dtx-obs {argv[0]} exited {rc}, not "
                                 f"{want}: {err.getvalue()[-2000:]}")
        return rc, out.getvalue()

    def expect(argv, rc, want):
        if rc != want:
            raise AssertionError(f"dtx-obs {argv[0]} exited {rc}; its "
                                 f"document implies {want}")

    def kept(*parts):
        return os.path.join(root, *parts)

    run_dirs = sorted(d for d, _s, files in os.walk(root)
                      if any(re.match(r"(metrics|spans)\.\d+\.jsonl$|"
                                      r"restarts\.jsonl$", f)
                             for f in files))
    wl_in = kept("replay", "workload.json")
    rc, out = run(["validate", *run_dirs, wl_in], 0)
    n_ok = sum(line.startswith("OK ") for line in out.splitlines())

    mon = kept("monitoring", "mon")
    _, out = run(["report", mon, "--summary"], 0)
    m = re.search(r"mfu=(\S+)", out)
    mfu = float(m.group(1)) if m else None
    if on_card and not (mfu is not None and 0 < mfu <= 1):
        raise AssertionError(f"report --summary: {out!r}")
    reports = []
    for name, logs in [(n, kept("monitoring", n)) for n in
                       ("mon", "skip", "halt", "tfm")] + [
                           ("status", kept("status"))]:
        reports.append(kept("reports", f"{name}.json"))
        os.makedirs(kept("reports"), exist_ok=True)
        run(["report", logs, "-o", reports[-1]], 0)

    _, out = run(["tail", mon, "-n", "100000"], 0)
    windows = [r["step"] for r in metrics.read_metrics(
        os.path.join(mon, "metrics.0.jsonl")) if r["kind"] == "window"]
    lines = [int(line.split()[2]) for line in out.splitlines()
             if re.match(r"\[p\d+\] step ", line)]
    if lines != windows:
        raise AssertionError(f"tail: window lines at steps {lines}, rows "
                             f"at {windows}")

    med = {}
    for name in OBS_COMPARE:
        rows = metrics.read_metrics(kept("monitoring", name,
                                         "metrics.0.jsonl"))
        med[name] = statistics.median(r["step_time_p50_ms"] for r in rows
                                      if r["kind"] == "window")
    verdicts = []
    for base, cand in (OBS_COMPARE, OBS_COMPARE[::-1]):
        rel = (med[cand] - med[base]) / med[base]
        if on_card and abs(rel) <= OBS_STEP_THRESHOLD:
            raise AssertionError(f"compare: step-time medians {med} within "
                                 f"{OBS_STEP_THRESHOLD} of each other")
        want = 3 if rel > OBS_STEP_THRESHOLD else 0
        _, out = run(["compare", kept("monitoring", base),
                      kept("monitoring", cand), "--threshold", "1e9",
                      "--thresholds",
                      f"step_time_p50_ms={OBS_STEP_THRESHOLD}"], want)
        st = json.loads(out)["metrics"]["step_time_p50_ms"]
        if (st["base"], st["cand"]) != (med[base], med[cand]):
            raise AssertionError(f"compare read medians {st}, the rows "
                                 f"{med}")
        verdicts.append(st["verdict"])

    traced = kept("traced")
    rids = sorted({r["rid"] for r in spans.load_spans(traced)
                   if r.get("event") == "submit"})
    argv = ["slo", traced, "--spec", TRACE_SLO]
    rc, out = run(argv)
    slo_doc = json.loads(out)
    expect(argv, rc, 3 if slo_doc["breaches"] else 0)
    if slo_doc["requests"] != len(rids):
        raise AssertionError(f"slo: {slo_doc['requests']} requests, the "
                             f"stream {len(rids)}")
    _, out = run(["trace", traced, str(rids[0])], 0)
    if json.loads(out)["record"].get("terminal") != "result":
        raise AssertionError(f"trace: {out[:500]}")
    chrome = kept("traced.chrome.json")
    run(["trace", traced, "--export", "chrome", "-o", chrome], 0)
    with open(chrome) as f:
        events = json.load(f)["traceEvents"]
    named = {e["name"] for e in events if e.get("cat") == "request"}
    if not {f"request {rid}" for rid in rids} <= named:
        raise AssertionError(f"chrome export names {sorted(named)}, the "
                             f"stream's rids {rids}")

    replay0 = kept("replay", "replay0")
    _, out = run(["explain", replay0], 0)
    if not out.splitlines()[-1].startswith(f"{REPLAY_N} request(s)"):
        raise AssertionError(f"explain: {out.splitlines()[-1]}")
    _, out = run(["explain", replay0, "--fleet"], 0)
    littles = json.loads(out)["littles_law"]

    for name in ("fleet", "chaos"):
        sources = sorted(d for d in glob.glob(kept(name, "*"))
                         if os.path.isdir(d))
        _, out = run(["collect", *sources], 0)
        if not out.strip():
            raise AssertionError(f"collect {name}: no rows")
        _, out = run(["fleet", *sources, "--spec", OBS_FLEET_SPEC], 0)
        if not json.loads(out)["exactly_once"]:
            raise AssertionError(f"fleet {name}: not exactly-once")

    wl = kept("captured.json")
    run(["capture", replay0, "-o", wl], 0)
    argv = ["capacity", wl, "--service-tok-s", repr(replay["tps"][0]),
            "--measured-qps", repr(replay["qps"][0])]
    rc, out = run(argv)
    fc = json.loads(out)
    expect(argv, rc, 0 if fc["verdict"]["ok"] else 3)
    batch = next(int(f.split("=")[1]) for f in flags
                 if f.startswith("--decode_max_batch="))
    kv_len = fc["mean_prompt_len"] + fc["mean_new_tokens"] / 2
    peak = flops.chip_peak_hbm_bytes()
    roof = capacity.roofline_decode_tok_s(spec, batch, kv_len)
    if on_card and not (peak == 3.35e12 and roof and roof > 0):
        raise AssertionError(f"capacity roofline {roof} (peak {peak}) on "
                             f"{card}")
    log(f"[obs] capacity of the first replay's capture: forecast "
        f"{fc['sustainable_qps']} qps a replica at {fc['service_tok_s']} "
        f"measured tokens/s (utilization target {fc['utilization_target']})"
        f", {fc['required_replicas']} replica(s) for {fc['offered_qps']} "
        f"offered qps; measured {fc['verdict']['measured_qps']} completed "
        f"qps (rel_err {fc['verdict']['rel_err']}, ok "
        f"{fc['verdict']['ok']}); roofline ceiling {roof} decode tokens/s "
        f"(HBM peak {peak} B/s over the decode bytes a step at batch "
        f"{batch}, kv {kv_len}) beside the measured {replay['tps'][0]} "
        f"tokens/s on {smi}")

    hist = kept("history.jsonl")
    for path in reports:
        run(["history", hist, "--append", path], 0)
    run(["history", hist], 0)
    argv = ["drift", hist]
    rc, out = run(argv)
    drift_doc = json.loads(out)
    expect(argv, rc, 0 if drift_doc["ok"] else 3)
    argv = ["drift", hist, "--capture", reports[0]]
    rc, out = run(argv)
    roofline = json.loads(out)["roofline"]
    expect(argv, rc, 0 if drift_doc["ok"] else 3)
    if on_card and roofline["chip_peak_hbm_gbps"] != round(peak / 1e9, 1):
        raise AssertionError(f"drift --capture: {roofline}")

    t0 = time.monotonic()
    rc, answers = _obs_serve(mon, ["/status", "/metrics", "/report"])
    ran.append(("serve", rc, time.monotonic() - t0))
    log(f"[obs] dtx-obs serve $KEPT/monitoring/mon: GET "
        f"{[(p, c) for p, c, _b in answers]}, rc {rc} on ^C in "
        f"{ran[-1][2]:.4f} s on {smi}")
    if rc != 0 or [c for _p, c, _b in answers] != [200, 200, 200]:
        raise AssertionError(f"serve: rc {rc}, {answers}")
    shutil.rmtree(root)
    wall = time.monotonic() - t_phase
    log(f"[obs] phase 9: {len(ran)} dtx-obs calls over {len(set(c for c, *_ in ran))}"
        f" subcommands in {wall:.2f} s ({n_ok} files valid; report mfu "
        f"{mfu}; compare {OBS_COMPARE} medians {med} ms -> {verdicts}; "
        f"drifts {[d['metric'] for d in drift_doc['drifts']]}; Little's law "
        f"holds {littles['holds']}; roofline join "
        f"{roofline['chip_peak_hbm_gbps']} GB/s) on {smi}")
    return dict(wall=wall, calls=len(ran), mfu=mfu, roof=roof,
                forecast=fc["sustainable_qps"], peak=peak)


# phase 10 (a): one torch-form violation of each of the port's nine
# dtx-lint rules, planted in a temporary tree (the CPU tests hold each
# rule on its own bad, good and edge fixtures)
LINT_PLANTED = {
    "parallel/mesh.py": (
        "import dataclasses\n\n\n@dataclasses.dataclass\nclass Mesh:\n"
        "    dp: int\n    data_group: object = None\n"),
    "parallel/step.py": (
        "import torch.distributed as dist\n\n\ndef f(x, mesh):\n"
        "    dist.all_reduce(x)\n"),
    "train/loop.py": (
        "def run(feed, timed_batches, step):\n"
        "    for i, batch in timed_batches(feed):\n"
        "        cost_dev = step(batch)\n"
        "        print(cost_dev.item())\n"),
    "obs/schema.py": 'METRICS_COMMON = {"v": (int,), "ghost": (int,)}\n',
    "obs/metrics.py": 'def row():\n    return {"v": 10}\n',
    "ops/fused.py": (
        "import torch\n\n\nclass Mul(torch.autograd.Function):\n"
        "    @staticmethod\n    def forward(ctx, x, y):\n"
        "        return x * y\n\n    @staticmethod\n"
        "    def backward(ctx, g):\n        return g, g, g\n"),
    "parallel/epoch.py": (
        "import torch\n\n\ndef capture(n):\n    for _ in range(n):\n"
        "        torch.cuda.CUDAGraph()\n"),
    "models/mlp.py": "import torch\n\n\ndef init():\n"
                     "    return torch.randn(3)\n",
    "config.py": ("def build(p):\n"
                  '    p.add_argument("--undocumented_flag", type=int)\n'),
    "obs/serve.py": 'def render(gauge):\n    gauge("dtx_ghost_total", 1)\n',
    "obs/buckets.py": 'WINDOW_BUCKETS = ("data_wait",)\n'
                      'TRACE_SCOPES = WINDOW_BUCKETS\nNAMED_SCOPES = ("ln",)\n',
    "obs/tracer.py": "def f(timer, t):\n    timer.charge('data_wiat', t)\n",
}

# phase 10 (c): the seed of the served IDX files and of the runs on them
MNIST_SEED = 1
MNIST_SIZES = (60000, 10000)     # MNIST's own train and test files


def _lint_json(argv) -> tuple:
    """The port's dtx-lint ``--json`` in process: (exit code, document,
    wall s)."""
    from distributed_tensorflow_example_tpu_torch.analysis import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv) + ["--json"])
    return rc, json.loads(buf.getvalue()), time.perf_counter() - t0


def phase_lint(card: str) -> dict:
    """Phase 10 (a): the port's lint over the port exits 0 with ``"ok":
    true``; the planted tree exits 1 and names every rule."""
    import distributed_tensorflow_example_tpu_torch as port
    from distributed_tensorflow_example_tpu_torch.analysis import cli

    pkg = os.path.dirname(os.path.abspath(port.__file__))
    rc, doc, wall = _lint_json([pkg])
    if rc != 0 or doc["ok"] is not True:
        raise AssertionError(f"lint: exit {rc} over the port, new "
                             f"findings {doc['new']}")
    with tempfile.TemporaryDirectory() as tmp:
        for rel, src in LINT_PLANTED.items():
            path = os.path.join(tmp, "pkg", rel)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w") as f:
                f.write(src)
        os.makedirs(os.path.join(tmp, "docs"))
        for name in ("API.md", "observability.md"):
            with open(os.path.join(tmp, "docs", name), "w") as f:
                f.write("# nothing documented\n")
        prc, pdoc, _ = _lint_json([os.path.join(tmp, "pkg")])
    named = {f["rule"] for f in pdoc["new"]}
    want = {r.id for r in cli.ALL_RULES}
    if prc != 1 or named != want:
        raise AssertionError(f"lint: the planted tree exited {prc} naming "
                             f"{sorted(named)}, want all of {sorted(want)}")
    log(f"[lint] phase 10 (a): the port's dtx-lint over {doc['modules']} "
        f"modules: exit 0, ok, {doc['suppressed']} findings under a "
        f"reasoned noqa, "
        f"{len(doc['baselined'])} baselined, in {wall:.3f} s; the planted "
        f"tree exits 1 naming all {len(want)} rules on {_card_limit()}")
    return dict(modules=doc["modules"], wall=wall,
                suppressed=doc["suppressed"])


def _masked(crc: int) -> int:
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _median_s(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def phase_native(card: str) -> dict:
    """Phase 10 (b): the g++ library builds and loads, its functions
    equal their numpy / Python forms bit for bit, and its gather and
    CRC32C are timed against them (host clock, median of repeats)."""
    from distributed_tensorflow_example_tpu_torch import native

    if os.environ.get("DTX_NO_NATIVE"):
        raise AssertionError("native: DTX_NO_NATIVE is set")
    t0 = time.perf_counter()
    if not native.native_available():
        raise AssertionError("native: the g++ library did not build or "
                             "load")
    load_s = time.perf_counter() - t0
    rng = np.random.RandomState(MNIST_SEED)
    if native.crc32c(b"123456789") != 0xE3069283:
        raise AssertionError("native: CRC32C check value")
    buf = rng.bytes(1 << 20)
    t0 = time.perf_counter()
    py = native.py_crc32c(buf)
    py_s = time.perf_counter() - t0
    if native.masked_crc32c(buf) != _masked(py):
        raise AssertionError("native: masked_crc32c differs from the "
                             "Python table's on 1 MiB")
    crc_s = _median_s(lambda: native.crc32c(buf), 50)
    images = rng.rand(55000, 784).astype(np.float32)
    labels = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 55000)]
    idx = rng.permutation(55000)[:100]
    gi, gl = native.gather_batch(images, labels, idx)
    if not (np.array_equal(gi, images[idx]) and np.array_equal(
            gl, labels[idx])):
        raise AssertionError("native: gather_batch differs from numpy")
    gather_s = _median_s(lambda: native.gather_batch(images, labels, idx),
                         200)
    numpy_s = _median_s(lambda: (images[idx], labels[idx]), 200)
    pix = rng.randint(0, 256, (10000, 784)).astype(np.uint8)
    # the library's arithmetic: a 256-entry table of i * (1/255) in f32
    lut = np.arange(256, dtype=np.float32) * (np.float32(1)
                                              / np.float32(255))
    got = native.u8_to_f32_scaled(pix)
    if not np.array_equal(got.view(np.uint32), lut[pix].view(np.uint32)):
        raise AssertionError("native: u8_to_f32_scaled differs from numpy")
    ulps = int(np.count_nonzero(
        lut != np.arange(256, dtype=np.float32) / np.float32(255)))
    smi = _card_limit()
    log(f"[native] phase 10 (b): built and loaded in {load_s:.3f} s; "
        f"one 100-row gather from 55,000 x 784 f32: native "
        f"{gather_s * 1e6:.2f} us, numpy {numpy_s * 1e6:.2f} us (median of "
        f"200, host clock); CRC32C native {len(buf) / crc_s / 1e6:.1f} "
        f"MB/s, Python {len(buf) / py_s / 1e6:.3f} MB/s on 1 MiB; "
        f"u8_to_f32_scaled bitwise numpy's i * (1/255) ({ulps} of 256 "
        f"values one ulp from i / 255) on {smi}")
    return dict(gather_us=gather_s * 1e6, numpy_us=numpy_s * 1e6,
                crc_mb_s=len(buf) / crc_s / 1e6,
                py_crc_mb_s=len(buf) / py_s / 1e6, load_s=load_s)


def _idx_archives(seed: int, sizes=MNIST_SIZES) -> dict:
    """MNIST's four gz IDX files at its own sizes, holding the port's
    synthetic digits of ``seed`` on the 8-bit pixel grid."""
    import gzip

    from distributed_tensorflow_example_tpu_torch.data import mnist

    out = {}
    for (img, lbl), n, s in (
            ((mnist.TRAIN_IMAGES, mnist.TRAIN_LABELS), sizes[0], 1),
            ((mnist.TEST_IMAGES, mnist.TEST_LABELS), sizes[1], 3)):
        split = mnist.synthesize_split(n, seed=seed + s)
        pix = np.round(split.images * 255.0).astype(np.uint8)
        out[img + ".gz"] = gzip.compress(
            struct.pack(">IIII", mnist.IMAGE_MAGIC, n, 28, 28)
            + pix.tobytes(), compresslevel=6, mtime=0)
        out[lbl + ".gz"] = gzip.compress(
            struct.pack(">II", mnist.LABEL_MAGIC, n)
            + split.labels.argmax(1).astype(np.uint8).tobytes(),
            compresslevel=6, mtime=0)
    return out


def _mirror(files: dict):
    """An in-process HTTP mirror of ``files`` on 127.0.0.1: (server,
    base URL, the names it was asked for)."""
    import http.server

    hits: list = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            name = self.path.rsplit("/", 1)[-1]
            hits.append(name)
            payload = files.get(name)
            if payload is None:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}/mnist/", hits


def phase_download(card: str, device: str = "cuda",
                   sizes=MNIST_SIZES) -> dict:
    """Phase 10 (c): the download behind a corrupt first mirror, the
    reference MLP trained on the downloaded files on both paths, and
    the refusal of the published digests end to end (``device`` and
    ``sizes`` let the CPU rehearse it at a small size)."""
    import hashlib

    from distributed_tensorflow_example_tpu_torch.data import download
    from distributed_tensorflow_example_tpu_torch.parallel import epoch

    t0 = time.perf_counter()
    files = _idx_archives(MNIST_SEED, sizes)
    make_s = time.perf_counter() - t0
    digests = {k: hashlib.sha256(v).hexdigest() for k, v in files.items()}
    corrupt = {k: v[:-4] + b"XXXX" for k, v in files.items()}
    good, good_base, good_hits = _mirror(files)
    bad, bad_base, bad_hits = _mirror(corrupt)
    runs = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            data_dir = os.path.join(tmp, "mnist")
            t0 = time.perf_counter()
            for name, digest in digests.items():
                path = download.download_file(
                    name, data_dir, mirrors=(bad_base, good_base),
                    sha256=digest)
                if download.sha256_file(path) != digest:
                    raise AssertionError(f"download: {name} digest")
            download_s = time.perf_counter() - t0
            if sorted(bad_hits) != sorted(files) \
                    or sorted(good_hits) != sorted(files):
                raise AssertionError(f"download: corrupt mirror asked for "
                                     f"{bad_hits}, good one for {good_hits}")
            for name, fast in (("mnist_host", False), ("mnist_fast", True)):
                argv = ["--pallas", "--training_epochs=1",
                        "--dataset=mnist", f"--data_dir={data_dir}",
                        f"--seed={MNIST_SEED}", f"--device={device}",
                        f"--logs_path={os.path.join(tmp, name)}"]
                if not fast:
                    argv.append("--no_fast_loop")
                res, out, counts = _run_trainer(argv, name, device,
                                                fast=fast)
                costs = re.findall(r"Cost: ([^,\s]+)", out)
                acc = re.findall(r"^Test-Accuracy: (\d+\.\d{2})$", out,
                                 flags=re.M)
                if not costs or not all(math.isfinite(float(c))
                                        for c in costs) or len(acc) != 1:
                    raise AssertionError(f"{name}: costs {costs}, "
                                         f"accuracy {acc}")
                # B1 a step, plus the test split's eval: 5 chunks of
                # --eval_batch_size 2000 on the host path; on the fast
                # path the epoch's eager warm-up steps and one chunk
                steps = res["steps"]
                want = (steps + epoch.WARMUP_STEPS + 1 if fast
                        else steps + -(-sizes[1] // 2000))
                if device == "cuda" and counts["mlp_forward"] != want:
                    raise AssertionError(
                        f"{name}: B1 launched {counts['mlp_forward']} "
                        f"times, predicted {want} ({steps} steps)")
                runs[name] = dict(counts=counts, steps=steps,
                                  first_cost=float(costs[0]),
                                  final_cost=float(costs[-1]),
                                  accuracy=float(acc[0]))
            # the published digests refuse the synthetic files: the first
            # archive is asked for once and refused, and the run exits
            # with JAX's FileNotFoundError and exit code 1; nothing is
            # fetched beyond 127.0.0.1
            n_good = len(good_hits)
            here = os.path.dirname(os.path.abspath(__file__))
            proc = subprocess.run(
                [sys.executable, "-m",
                 "distributed_tensorflow_example_tpu_torch.main",
                 "--dataset=mnist", f"--mnist_mirrors={good_base}",
                 f"--data_dir={os.path.join(tmp, 'empty')}",
                 "--training_epochs=0", f"--device={device}",
                 f"--logs_path={os.path.join(tmp, 'refused')}"],
                capture_output=True, text=True, timeout=300, cwd=here,
                env=dict(os.environ, PYTHONPATH=here))
            err = proc.stderr
            if proc.returncode != 1 or "FileNotFoundError: MNIST IDX files " \
                    "not found in" not in err or "SHA-256 mismatch" not in err \
                    or len(good_hits) - n_good != 1:
                raise AssertionError(f"download refusal: exit "
                                     f"{proc.returncode}, stderr "
                                     f"{err[-2000:]}")
    finally:
        for srv in (good, bad):
            srv.shutdown()
            srv.server_close()
    smi = _card_limit()
    sizes = sum(len(v) for v in files.values())
    log(f"[download] phase 10 (c): {sizes} B of gz IDX files made in "
        f"{make_s:.2f} s, downloaded behind a corrupt first mirror (4 "
        f"rejected by SHA-256) in {download_s:.3f} s; "
        + "; ".join(f"{n}: {r['steps']} steps, cost {r['first_cost']:.4f} "
                    f"-> {r['final_cost']:.4f}, Test-Accuracy "
                    f"{r['accuracy']:.2f}, B1 {r['counts']['mlp_forward']}"
                    for n, r in runs.items())
        + f"; the published digests refuse them (exit 1, JAX's message) on "
        f"{smi}")
    return dict(runs=runs, download_s=download_s, make_s=make_s,
                bytes=sizes)


def main() -> int:
    if sys.argv[1:2] == ["--dp-phase"]:     # phase 5d's own process
        args = json.loads(sys.argv[2])
        runs = dp_child(args)
        with open(args["out"], "w") as f:
            json.dump(runs, f)
        return 0
    if sys.argv[1:2] == ["--tp-phase"]:     # a rank of phase 5e
        args, rank = json.loads(sys.argv[2]), int(sys.argv[3])
        runs = tp_child(args, rank)
        with open(f"{args['out']}.{rank}", "w") as f:
            json.dump(runs, f)
        return 0
    if sys.argv[1:2] == ["--sp-phase"]:     # a rank of phase 5g
        args, rank = json.loads(sys.argv[2]), int(sys.argv[3])
        runs = sp_child(args, rank)
        with open(f"{args['out']}.{rank}", "w") as f:
            json.dump(runs, f)
        return 0
    if sys.argv[1:2] == ["--ep-phase"]:     # a rank of phase 5h
        args, rank = json.loads(sys.argv[2]), int(sys.argv[3])
        runs = ep_child(args, rank)
        with open(f"{args['out']}.{rank}", "w") as f:
            json.dump(runs, f)
        return 0
    if sys.argv[1:2] == ["--pp-phase"]:     # a rank of phase 5i
        args, rank = json.loads(sys.argv[2]), int(sys.argv[3])
        runs = pp_child(args, rank)
        with open(f"{args['out']}.{rank}", "w") as f:
            json.dump(runs, f)
        return 0
    if sys.argv[1:2] == ["--sample-phase"]:     # a rank of phase 7e (a)
        args, rank = json.loads(sys.argv[2]), int(sys.argv[3])
        runs = sample_child(args, rank)
        with open(f"{args['out']}.{rank}", "w") as f:
            json.dump(runs, f)
        return 0
    if sys.argv[1:2] == ["--site-phase"]:   # a rank of phase 5f
        args, rank = json.loads(sys.argv[2]), int(sys.argv[3])
        runs = site_child(args, rank)
        with open(f"{args['out']}.{rank}", "w") as f:
            json.dump(runs, f)
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs on the card", file=sys.stderr)
        return 1
    card = torch.cuda.get_device_name(0)
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} on {card}")
    t0 = time.monotonic()
    # the streams phases 4b, 4d-4g and 5c keep for phase 9 (dtx-obs),
    # which removes the directory; removed at exit should a phase fail
    obs_root = tempfile.mkdtemp(prefix="dtx-obs-")
    atexit.register(shutil.rmtree, obs_root, True)
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
    phase_http_traced(keep=obs_root)
    phase_status(keep=obs_root)
    fleet = phase_fleet(card, serve, keep=obs_root)
    phase_chaos(card, serve, keep=obs_root)
    replay = phase_replay(card, keep=obs_root)
    trace = phase_trace_overhead(card, serve)
    serve_scopes = phase_serve_scopes(card, serve)
    del serve["params"]
    torch.cuda.empty_cache()
    train = phase_train(card)
    resilience = phase_resilience(card)
    monitoring = phase_monitoring(card, train["counts"], keep=obs_root)
    obs = phase_obs(card, obs_root, serve["spec"], replay)
    dp = phase_dp(card)
    tp = phase_tp(card)
    sites = phase_sites(card)
    sp = phase_sp(card)
    for row in sp["kernels"]:
        dict(measured)[row["kernel"]].append(row)
    ep = phase_ep(card)
    for row in ep["kernels"]:
        dict(measured)[row["kernel"]].append(row)
    pp = phase_pp(card)
    for row in pp["kernels"]:
        dict(measured)[row["kernel"]].append(row)
    cli = phase_cli(card)
    tfm_train = phase_transformer_train(card)
    phase_transformer_step(card)
    tfm_wide = phase_transformer_train(card, WIDE_HEAD_FLAGS, "tfm-wide-head")
    phase_transformer_step(card, WIDE_HEAD_STEP_FLAGS, "tfm-wide-head-step")
    moe_train = phase_moe_train(card)
    moe_step = phase_moe_step(card)
    last = phase_last_outputs(card, monitoring)
    lint = phase_lint(card)
    native = phase_native(card)
    mnist_dl = phase_download(card)
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
               "fleet": fleet["counts"], "replay": replay["counts"],
               "mlp_train": train["counts"],
               "resilience": resilience["counts"],
               "resilience_resumed": resilience["resumed_counts"],
               "monitoring": monitoring["counts"],
               "monitoring_skip": monitoring["skip_counts"],
               "monitoring_halt": monitoring["halt_counts"],
               "monitoring_tfm": monitoring["tfm_counts"],
               **{f"dp_{name}": r["counts"] for name, r in dp.items()},
               **{f"{name}_rank{i}": m["counts"]
                  for name, r in tp["runs"].items()
                  for i, m in enumerate(r["ranks"])},
               **{f"{name}_one_rank": r["ref"]["counts"]
                  for name, r in tp["runs"].items()},
               **{f"{name}_rank{i}": rk[name]["counts"]
                  for i, rk in enumerate(sites["ranks"])
                  for name in rk},
               **{f"{name}_rank{i}": m["counts"]
                  for name, r in sp["runs"].items()
                  for i, m in enumerate(r["ranks"])},
               "sp_one_rank": sp["ref"]["counts"],
               **{f"{name}_rank{i}": m["counts"]
                  for name, r in ep["runs"].items()
                  for i, m in enumerate(r["ranks"])},
               **{f"{name}_one_rank": r["ref"]["counts"]
                  for name, r in ep["runs"].items()},
               **{f"{name}_rank{i}": m["counts"]
                  for name, r in pp["runs"].items()
                  for i, m in enumerate(r["ranks"])},
               "pp_one_rank": pp["ref"]["counts"],
               "mlp_cli": cli["counts"],
               "transformer_train": tfm_train["counts"],
               "transformer_wide_head": tfm_wide["counts"],
               "moe_train": moe_train[0]["counts"],
               "moe_train_fp8": moe_train[1]["counts"],
               **{f"sample_rank{i}": m["counts"]
                  for i, m in enumerate(last["sample"]["ranks"])},
               **{name: r["counts"] for name, r in mnist_dl["runs"].items()}}
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
    smi = _card_limit()
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
    log(f"[replay] tokens/s {[round(t, 1) for t in replay['tps']]} (one "
        f"engine twice, then 2 replicas), determinism_frac "
        f"{replay['determinism_frac']} (mismatching rids "
        f"{replay['mismatches']}) on {smi}")
    log(f"[resilience] ckpt_stall_ms median "
        f"{statistics.median(resilience['stall_ms']):.4f} of "
        f"{resilience['stall_ms']}, snapshot write {resilience['write_ms']:.1f}"
        f" ms mean, {resilience['snap_bytes']} bytes a snapshot, "
        f"{resilience['bytes_written']} written on {smi}")
    ab, hist = monitoring["skip_ab"], monitoring["host_hist"]
    log(f"[monitoring] graph path mfu {monitoring['mfu']}, skip mask "
        f"median {statistics.median(ab['skip']):.4f} vs plain "
        f"{statistics.median(ab['plain']):.4f} ms a step; host path "
        f"--histograms median {statistics.median(hist['histograms']):.3f} "
        f"vs plain {statistics.median(hist['plain']):.3f} ms; blow-up first "
        f"flagged step {monitoring['first_flagged']}, halted at step "
        f"{monitoring['halt_step']}; transformer_wide_long mfu "
        f"{monitoring['tfm_mfu']} on {smi}")
    log(f"[obs] phase 9: {obs['calls']} dtx-obs calls in {obs['wall']:.2f} s"
        f" over the kept streams; report mfu {obs['mfu']}; capacity "
        f"forecast {obs['forecast']} qps, roofline ceiling {obs['roof']} "
        f"decode tokens/s at HBM peak {obs['peak']} B/s on {smi}")
    for name, r in dp.items():
        log(f"[dp] {name}: step {r['step_ms']:.4f} ms (CUDA events), peak "
            f"memory {r['peak_gib']:.3f} GiB, collectives device ms "
            f"{r['collectives_ms']} in a one-rank NCCL group on {smi}")
    for name, r in tp["runs"].items():
        for i, m in enumerate(r["ranks"]):
            log(f"[tp] {name} rank {i} of {TP_MP} (gloo on one card): "
                f"warm step {statistics.median(m['warm_step_ms']):.2f} ms "
                f"(host clock, gloo-bound), peak memory "
                f"{m['peak_gib']:.3f} GiB, {m['params_held']} params held; "
                f"one rank "
                f"{statistics.median(r['ref']['warm_step_ms']):.2f} ms, "
                f"{r['ref']['peak_gib']:.3f} GiB, "
                f"{r['ref']['params_held']} params on {smi}")
    for i, rk in enumerate(sites["ranks"]):
        for name, m in rk.items():
            if name == "site_equiv":
                continue
            log(f"[sites] {name} site {i} of {SITES} (gloo on one card): "
                f"round {statistics.median(m['round_ms']):.2f} ms, outer "
                f"sync {statistics.median(m['sync_ms']):.2f} ms (host "
                f"clock, gloo's host staging), {m['payload']} B a round "
                f"(closed forms: f32 {m['f32_form']:.0f}, int8 "
                f"{m['int8_form']:.0f} B a site), peak memory "
                f"{m['peak_gib']:.3f} GiB on {smi}")
    for name, r in sp["runs"].items():
        for i, m in enumerate(r["ranks"]):
            log(f"[sp] {name} rank {i} of {SP_DEG} (gloo on one card): "
                f"warm step {statistics.median(m['warm_step_ms']):.2f} ms "
                f"(host clock, gloo-bound), {m['step_bytes']} B posted a "
                f"step to the seq axis's collectives (closed form "
                f"{m['closed_bytes']}), {m['wire']['loopback']} B on the "
                f"loopback for one block's attention (both ranks), first "
                f"step's gradient rel L2 err {m['grad_errs']['all']:.3g}, peak "
                f"memory {m['peak_gib']:.3f} GiB; one rank "
                f"{statistics.median(sp['ref']['warm_step_ms']):.2f} ms, "
                f"{sp['ref']['peak_gib']:.3f} GiB on {smi}")
    for name, r in ep["runs"].items():
        for i, m in enumerate(r["ranks"]):
            log(f"[ep] {name} rank {i} of {EP_DEG} (gloo on one card): "
                f"warm step {statistics.median(m['warm_step_ms']):.2f} ms "
                f"(host clock, gloo's host staging), {m['step_bytes']} B "
                f"posted a step to the expert axis (closed form "
                f"{m['closed_bytes']}), {m['params_held']} params held, "
                f"peak memory {m['peak_gib']:.3f} GiB; one rank "
                f"{statistics.median(r['ref']['warm_step_ms']):.2f} ms, "
                f"{r['ref']['params_held']} params, "
                f"{r['ref']['peak_gib']:.3f} GiB on {smi}")
    for name, r in pp["runs"].items():
        for i, m in enumerate(r["ranks"]):
            log(f"[pp] {name} stage {i} of {PP_DEG} (gloo on one card): "
                f"warm step {statistics.median(m['warm_step_ms']):.2f} ms "
                f"(host clock: gloo's host staging, not PP across cards), "
                f"{m['step_bytes']} B posted a step to the stage hops "
                f"(closed form {m['closed_bytes']}), first step's gradient "
                f"rel L2 err {m['grad_errs']['all']:.3g}, peak memory "
                f"{m['step_peak_gib']:.3f} GiB over the steps; one rank "
                f"{statistics.median(pp['ref']['warm_step_ms']):.2f} ms, "
                f"{pp['ref']['step_peak_gib']:.3f} GiB on {smi}")
    for name, r in train["runs"].items():
        log(f"[train] {name}: median step {r['step_ms_median']:.3f} ms, "
            f"peak memory {r['peak_gib']:.3f} GiB on {smi}")
    log(f"[train] graph replays alone: median step "
        f"{train['replay_ms_median']:.4f} ms on {smi}")
    for tag, r in (("tfm-train", tfm_train), ("tfm-wide-head", tfm_wide)):
        log(f"[{tag}] peak memory {r['peak_gib']:.2f} GiB, median step "
            f"{r['step_ms_median']:.1f} ms, {r['tokens_per_s']:.0f} "
            f"tokens/s, {r['model_tflops_per_s']:.2f} model TFLOP/s, warm "
            f"epoch {r['epoch_step_ms']:.2f} ms a step on {smi}")
    for row in moe_train:
        log(f"[moe-train] {' '.join(row['flags'])}: peak memory "
            f"{row['peak_gib']:.2f} GiB, median step "
            f"{row['step_ms_median']:.1f} ms, warm epoch "
            f"{row['epoch_step_ms']:.2f} ms a step on {smi}")
    sample, med = last["sample"], last["dump"]["medians"]
    log(f"[7e] sampling over {SAMPLE_DP} data ranks: rank decodes "
        f"{[round(m['decode_ms'], 1) for m in sample['ranks']]} ms vs one "
        f"rank's decode of all {sample['ranks'][0]['prompts']} "
        f"{sample['all_ms']:.1f} ms; graph dump host cost on "
        f"transformer_wide_long's step "
        f"{med['dump']['host'] - med['plain']['host']:.2f} ms (plain host "
        f"{med['plain']['host']:.2f} ms, wall {med['plain']['wall']:.2f}); "
        f"named scopes: step wall on {med['plain']['wall']:.2f} vs off "
        f"{med['scopes_off']['wall']:.2f} ms, decode tick (shipped, open, "
        f"none) {serve_scopes['tick_ms']}, one empty scope "
        f"{serve_scopes['us']['scope']:.3f} us; MoE "
        f"ranges {moe_step['scopes']}; --fsdp --debug_nans blow-up "
        f"{dp['fsdp_nans']['blowup']!r} on {smi}")
    log(f"[10] dtx-lint {lint['modules']} modules in {lint['wall']:.3f} s; "
        f"native gather {native['gather_us']:.2f} us vs numpy "
        f"{native['numpy_us']:.2f} us, CRC32C {native['crc_mb_s']:.1f} vs "
        f"{native['py_crc_mb_s']:.3f} MB/s; MNIST download "
        f"{mnist_dl['download_s']:.3f} s on {smi}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
