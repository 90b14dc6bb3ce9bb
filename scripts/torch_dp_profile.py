"""What the data-parallel strategies add to a full-width training step
of the PyTorch port, at world 1, and what two ranks sharing one card do.

    python3 scripts/torch_dp_profile.py [--steps 8] [--out FILE]
        [--skip_two_ranks]

The trainer's full-width configuration (``chip_smoke.py``'s
``WIDE_TRAIN``: 784-4096-4096-10, relu, bf16 compute over f32 params,
global batch 8192, ``--pallas``) under Adam, in a one-rank NCCL group
(the group ``cluster.bootstrap`` sets up from ``--coordinator_address``
with ``--num_processes=1``), each strategy's step as
``train/loop.setup_strategy`` builds it:

- ``plain``: the synchronous step (its all-reduce of every gradient);
- ``zero``: ZeRO-1 (the Adam update on flat chunks, the params
  all-gathered);
- ``fsdp``: FSDP (params all-gathered, gradients reduce-scattered, the
  update on the flat shards);
- ``sync_period``: local SGD at K=2 (the local step, and the average of
  the params and slots every second step).

For each: the step's device time on CUDA events (``--steps`` eager
steps after two, so every strategy is timed the same way; local SGD
alternates its two forms), then one step pair under ``torch.profiler``:
the device ms of each collective (the dispatcher's ``c10d::`` ops, the
kernels and copies they launched), of the flat copies around them
(``torch.cat`` pads, ``copy_``, ``Memcpy``), and the busy total.

Then, unless ``--skip_two_ranks``, one attempt at two ranks on the one
card: two processes, the plain step at global batch 8192 (4096 rows a
rank) over a gloo group carrying CUDA tensors, timed on the host clock
beside one rank alone; and two processes over NCCL, which refuses two
ranks on one device (the error is recorded).  Prints the card's name
and power limit; the numbers go to ``--out`` as JSON.  Needs one card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys

import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

STRATEGIES = {"plain": {}, "zero": dict(zero_opt=True, fast_loop=False),
              "fsdp": dict(fsdp=True), "sync_period": dict(sync_period=2)}
COPY_MARKS = ("copy", "cat", "memcpy", "fill")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _base_cfg(device: str = "cuda"):
    import chip_smoke
    from distributed_tensorflow_example_tpu_torch.config import Config

    return Config(**dict(chip_smoke.WIDE_TRAIN, optimizer="adam"),
                  device=device, num_processes=1, task_index=0)


def _batch(cfg):
    from distributed_tensorflow_example_tpu_torch.data import mnist

    split = mnist.synthesize_split(cfg.batch_size, seed=cfg.seed)
    return (torch.from_numpy(split.images).cuda(),
            torch.from_numpy(split.labels).cuda())


def profile_strategies(steps: int) -> dict:
    """Each strategy's eager step at world 1: CUDA-event ms, and the
    profiled device ms of its collectives and flat copies."""
    from torch.profiler import ProfilerActivity, profile

    from distributed_tensorflow_example_tpu_torch import cluster
    from distributed_tensorflow_example_tpu_torch.parallel import mesh, step
    from distributed_tensorflow_example_tpu_torch.train import loop, optim
    from distributed_tensorflow_example_tpu_torch.train.state import (
        create_train_state)

    base = _base_cfg()
    cluster.bootstrap(dataclasses.replace(
        base, coordinator_address=f"127.0.0.1:{_free_port()}"))
    spec = loop.make_spec(base)
    x, y = _batch(base)
    out = {}
    for name, flags in STRATEGIES.items():
        cfg = dataclasses.replace(base, **flags)
        opt = optim.make_optimizer(cfg, steps)
        strat = loop.setup_strategy(
            cfg, spec, opt, create_train_state(spec, opt, seed=cfg.seed,
                                               device="cuda"),
            mesh.build_mesh(-1), fast=False)
        body = strat.body or step.make_sync_step_body(cfg, spec, opt)
        state = strat.state
        n = [0]

        def one():
            nonlocal state
            state = body(state, x, y)[0]
            n[0] += 1
            if strat.sync_period and n[0] % strat.sync_period == 0:
                state = step.param_sync(state)

        for _ in range(2):
            one()
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(steps):
            one()
        ev[1].record()
        torch.cuda.synchronize()
        step_ms = ev[0].elapsed_time(ev[1]) / steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            one()
            one()
            torch.cuda.synchronize()
        coll, copies, busy = {}, 0.0, 0.0
        for e in prof.key_averages():
            key = e.key.lower()
            dev_us = getattr(e, "device_time_total", 0.0) or 0.0
            if key.startswith("c10d::"):
                kind = ("all_reduce" if "allreduce" in key
                        else "all_gather" if "allgather" in key
                        else "reduce_scatter" if "reduce_scatter" in key
                        else key)
                coll[kind] = coll.get(kind, 0.0) + dev_us / 2e3
        for e in prof.key_averages():
            if getattr(e, "device_type", None) is None:
                continue
            self_us = getattr(e, "self_device_time_total", 0.0) or 0.0
            if str(e.device_type).endswith("CUDA") and self_us:
                busy += self_us / 2e3
                if any(m in e.key.lower() for m in COPY_MARKS):
                    copies += self_us / 2e3
        out[name] = dict(step_ms=step_ms, collectives_ms=coll,
                         copies_ms=copies, busy_ms=busy,
                         peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        print(f"[dp-profile] {name}: {step_ms:.4f} ms a step (CUDA "
              f"events, {steps} eager steps), device busy {busy:.4f} ms, "
              f"collectives {coll}, flat copies {copies:.4f} ms",
              flush=True)
        del state, strat, body
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    cluster.shutdown()
    return out


# one rank of the two-ranks-on-one-card attempt: the plain step at its
# share of the global batch, timed on the host clock
RANK_PROGRAM = r'''
import dataclasses, json, sys, time
import torch, torch.distributed as dist
sys.path.insert(0, sys.argv[5])
rank, world, port, backend = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
torch.cuda.set_device(0)
out = {"rank": rank, "backend": backend}
try:
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    import chip_smoke
    from distributed_tensorflow_example_tpu_torch.config import Config
    from distributed_tensorflow_example_tpu_torch.data import mnist
    from distributed_tensorflow_example_tpu_torch.parallel import step
    from distributed_tensorflow_example_tpu_torch.train import loop, optim
    from distributed_tensorflow_example_tpu_torch.train.state import (
        create_train_state)
    cfg = Config(**dict(chip_smoke.WIDE_TRAIN, optimizer="adam"),
                 device="cuda")
    spec = loop.make_spec(cfg)
    opt = optim.make_optimizer(cfg, 8)
    body = step.make_sync_step_body(cfg, spec, opt)
    state = create_train_state(spec, opt, seed=1, device="cuda")
    b = cfg.batch_size // world
    split = mnist.synthesize_split(cfg.batch_size, seed=1)
    x = torch.from_numpy(split.images[rank * b:(rank + 1) * b]).cuda()
    y = torch.from_numpy(split.labels[rank * b:(rank + 1) * b]).cuda()
    for _ in range(2):
        state = body(state, x, y)[0]
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(8):
        state, cost, _acc = body(state, x, y)
    torch.cuda.synchronize()
    out["step_ms"] = (time.perf_counter() - t0) * 1e3 / 8
    out["cost"] = float(cost)
    dist.destroy_process_group()
except Exception as e:
    out["error"] = f"{type(e).__name__}: {e}"[:600]
print("RESULT " + json.dumps(out), flush=True)
'''


def two_ranks(backend: str, world: int, timeout: float = 300) -> list:
    """``world`` processes of RANK_PROGRAM on the one card over
    ``backend``; each rank's result (or error)."""
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_PROGRAM, str(r), str(world), port,
         backend, _REPO], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    results = []
    for p in procs:
        try:
            text = p.communicate(timeout=timeout)[0]
        except subprocess.TimeoutExpired:
            p.kill()
            text = p.communicate()[0] + "\nRESULT " + json.dumps(
                {"error": f"timed out after {timeout} s"})
        line = [ln for ln in text.splitlines() if ln.startswith("RESULT ")]
        results.append(json.loads(line[-1][7:]) if line
                       else {"error": text[-600:]})
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--out", default=os.path.join(
        _REPO, "build", "torch_dp_profile.json"))
    ap.add_argument("--skip_two_ranks", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_dp_profile: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    import chip_smoke

    chip_smoke.phase_build()
    report = {"card": smi, "strategies": profile_strategies(args.steps)}
    if not args.skip_two_ranks:
        report["one_rank_gloo"] = two_ranks("gloo", 1)
        report["two_ranks_gloo"] = two_ranks("gloo", 2)
        report["two_ranks_nccl"] = two_ranks("nccl", 2, timeout=120)
        for k in ("one_rank_gloo", "two_ranks_gloo", "two_ranks_nccl"):
            print(f"[dp-profile] {k}: {report[k]}", flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(smi)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
