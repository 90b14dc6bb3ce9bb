"""Where the time of a two-replica fleet on one card goes, against one
engine on the same card.

    python3 scripts/torch_fleet_profile.py [--rounds 2] [--out FILE]

Builds ``chip_smoke.py``'s serving model on the card once (the decode
bench model: d_model 1024, 8 heads, 4 blocks, d_ff 4096, seq_len 1024,
bf16 compute over f32 params, ``fused_ln`` + ``fp8_ffn``) and serves
phase 3's 8 ragged greedy requests (32 new tokens each) two ways, each
on its own thread(s): one engine, and two engines over the same params
behind ``serving/router.Router``.  Every request is submitted before the
engines start, so each arm runs the same ticks every time (the fleet's
placement splits the 8 requests 4 and 4).  The arms run in turns (one,
fleet, fleet, one, ...) for ``--rounds`` rounds at the interpreter's
default switch interval, then one round at a 0.1 ms switch interval,
then the fleet once more under ``torch.profiler``.  Prints, per run: the
wall from the engines' start to the last result, tokens/s, each engine's
decode ticks and wall per tick; for the profiled run, the device busy
time and the idle share of the wall.  The same numbers go to ``--out``
as JSON.  Needs one card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)


def _serve(spec, params, prompts, n_new: int, replicas: int) -> dict:
    """The requests through ``replicas`` engines (a router over them when
    more than one), all submitted before the engines start."""
    from distributed_tensorflow_example_tpu_torch.serving import router
    from distributed_tensorflow_example_tpu_torch.serving.engine import (
        DecodeEngine)

    engines = [DecodeEngine(spec, params, page_size=16, max_batch=8,
                            device="cuda") for _ in range(replicas)]
    front = router.Router(engines) if replicas > 1 else engines[0]
    rids = [front.submit(p, n_new) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for e in engines:
        e.start()
    results = [front.result(r, timeout=600) for r in rids]
    wall = time.monotonic() - t0
    for e in engines:
        e.stop()
    if any(r is None or r["status"] != "result" for r in results):
        raise AssertionError(f"bad results: {results}")
    ticks = [e.stats()["decode_ticks_total"] for e in engines]
    return {"replicas": replicas, "wall_s": wall,
            "tokens_per_s": sum(len(r["tokens"]) for r in results) / wall,
            "decode_ticks": ticks,
            "ms_per_tick": [wall * 1e3 / t for t in ticks],
            "requests": ([sum(front._requests[r].replica_index == i
                                  for r in rids) for i in range(replicas)]
                         if replicas > 1 else [len(rids)])}


def _busy_ms(prof) -> float:
    total = 0.0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        total += us if us is not None else getattr(ev, "self_cuda_time_total",
                                                   0.0)
    return total / 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=os.path.join(
        _REPO, "build", "torch_fleet_profile.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_fleet_profile: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from distributed_tensorflow_example_tpu_torch.models import (
        transformer as tfm)

    card = torch.cuda.get_device_name(0)
    spec = tfm.TransformerSpec(**chip_smoke.FULL_WIDTH,
                               compute_dtype=torch.bfloat16)
    params = tfm.init(spec, seed=0, device="cuda")
    prompts, n_new = chip_smoke._serve_requests(spec)
    _serve(spec, params, prompts, n_new, 1)          # warm-up
    runs = []

    def run(replicas, switch):
        prev = sys.getswitchinterval()
        sys.setswitchinterval(switch)
        try:
            doc = _serve(spec, params, prompts, n_new, replicas)
        finally:
            sys.setswitchinterval(prev)
        doc["switch_interval_s"] = switch
        runs.append(doc)
        print(f"[fleet-profile] {replicas} engine(s), switch interval "
              f"{switch * 1e3:g} ms: {doc['tokens_per_s']:.1f} tokens/s in "
              f"{doc['wall_s']:.3f} s, requests {doc['requests']}, decode "
              f"ticks {doc['decode_ticks']}, "
              f"{', '.join(f'{m:.3f}' for m in doc['ms_per_tick'])} ms of "
              f"wall a tick on {card}", flush=True)

    default = sys.getswitchinterval()
    for r in range(args.rounds):
        for replicas in ((1, 2) if r % 2 == 0 else (2, 1)):
            run(replicas, default)
        for replicas in ((2, 1) if r % 2 == 0 else (1, 2)):
            run(replicas, default)
    for replicas in (1, 2):
        run(replicas, 1e-4)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        doc = _serve(spec, params, prompts, n_new, 2)
    torch.cuda.synchronize()
    busy = _busy_ms(prof)
    prof_doc = {"wall_s": doc["wall_s"], "device_busy_ms": busy,
                "device_idle_share": 1 - busy / (doc["wall_s"] * 1e3),
                "decode_ticks": doc["decode_ticks"]}
    print(f"[fleet-profile] 2 engines under torch.profiler: wall "
          f"{doc['wall_s'] * 1e3:.1f} ms, device busy {busy:.1f} ms, idle "
          f"share {prof_doc['device_idle_share']:.3f} on {card}", flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "runs": runs, "profiled_fleet": prof_doc,
                   "tick_ms_median": {
                       str(n): float(np.median([m for d in runs
                                                if d["replicas"] == n
                                                and d["switch_interval_s"]
                                                == default
                                                for m in d["ms_per_tick"]]))
                       for n in (1, 2)}}, f, indent=1)
    print(f"[fleet-profile] wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
