"""Where a full-width training step of the PyTorch port spends its time,
on the trainer's default fast path and on its host path.

    python3 scripts/torch_training_profile.py [--steps 8] [--out FILE]
        [--paths graph,host,host_prefetch] [--on_anomaly skip]

Builds ``chip_smoke.py``'s full-width trainer configuration on the card
(the JAX repo's ``mxu_wide_pallas`` bench row: 784-4096-4096-10, relu,
bf16 compute over f32 params, global batch 8192, ``--pallas``, SGD) and
runs its step three ways, each as ``train/loop.run`` runs it:

- ``graph``: the device-resident epoch (``parallel/epoch.py``) with the
  step replayed as a CUDA graph — the split staged on the card, each
  epoch shuffled there, ``--steps`` replays an epoch, the costs fetched
  once an epoch;
- ``host``: ``--no_fast_loop`` — ``EpochIterator`` batches from the
  producer thread (``EpochPrefetcher``), copied to the card from
  pageable memory, one step, the cost fetched every step (the print of
  ``--frequency=1``);
- ``host_prefetch``: the same under ``--device_prefetch`` — the
  producer gathering each batch into pinned memory, non-blocking
  copies on a copy stream, 8 batches ahead.

``--on_anomaly skip`` builds every path's step with the trainer's skip
mask (the per-leaf non-finite counts and the ``torch.where`` on their
flag, inside the graph on the graph path); ``--paths`` picks the paths.

Each runs one epoch of warm-up (the graph's capture included), then one
epoch timed on the host clock, then one more under ``torch.profiler``.
Prints the host wall per step (the unprofiled epoch), the device busy
time per step (the sum of CUDA kernel times, profiled epoch), the idle
share ``1 - busy / wall``, the kernels by device time and the card's
name and power limit; the same numbers go to ``--out`` as JSON.  Needs
one card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=8,
                    help="steps an epoch (batches of 8192)")
    ap.add_argument("--out", default=os.path.join(
        _REPO, "build", "torch_training_profile.json"))
    ap.add_argument("--paths", default="graph,host,host_prefetch",
                    help="comma-separated: graph, host, host_prefetch")
    ap.add_argument("--on_anomaly", default="", choices=["", "skip"],
                    help="the step with --on_anomaly's skip mask")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from torch_serving_profile import _kernel_table, _print

    from distributed_tensorflow_example_tpu_torch.config import Config
    from distributed_tensorflow_example_tpu_torch.data import (
        CopyStreamCommit, DevicePrefetcher, EpochIterator, EpochPrefetcher,
        mnist, pinned_batches, take)
    from distributed_tensorflow_example_tpu_torch.parallel import epoch, step
    from distributed_tensorflow_example_tpu_torch.train import loop, optim
    from distributed_tensorflow_example_tpu_torch.train.state import (
        create_train_state)
    from distributed_tensorflow_example_tpu_torch.utils import prng

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cfg = Config(**chip_smoke.WIDE_TRAIN, device="cuda",
                 on_anomaly=args.on_anomaly)
    spec = loop.make_spec(cfg)
    opt = optim.make_optimizer(cfg)
    n = args.steps * cfg.batch_size
    data = mnist.synthesize_split(n, seed=1)

    def graph_path():
        img, lbl, spe = epoch.shard_dataset(data.images, data.labels,
                                            cfg.batch_size, "cuda")
        runner = epoch.build_epoch_runner(cfg, spec, opt, spe, "cuda")
        key = prng.PRNGKey(cfg.seed + epoch.SHUFFLE_SALT)
        state = create_train_state(spec, opt, seed=cfg.seed, device="cuda")
        e = 0

        def one_epoch():
            nonlocal state, e
            state, costs, _accs = runner(state, img, lbl, key, e)
            costs.cpu()                       # the loop's per-epoch fetch
            e += 1

        return one_epoch

    def host_path(prefetch: bool):
        body = step.make_sync_step_body(cfg, spec, opt)
        state = create_train_state(spec, opt, seed=cfg.seed, device="cuda")
        it = EpochIterator(data, cfg.batch_size, seed=cfg.seed)
        feeder = EpochPrefetcher(
            (lambda e: pinned_batches(data, it.batch_indices(e)))
            if prefetch else it.epoch, range(3))
        dev_feed = (DevicePrefetcher(CopyStreamCommit("cuda"), depth=8)
                    if prefetch else None)
        e = 0

        def one_epoch():
            nonlocal state, e
            feed = feeder.epoch(e)
            if dev_feed is not None:
                feed = dev_feed.rewind(feed)
            for item in feed:
                if dev_feed is not None:
                    x, y = take(*item)
                else:
                    x = torch.from_numpy(item[0]).to("cuda")
                    y = torch.from_numpy(item[1]).to("cuda")
                state, cost, _acc = body(state, x, y)
                float(cost)             # the print fetch (frequency 1)
            e += 1

        return one_epoch

    report = {"card": card, "steps": args.steps,
              "on_anomaly": args.on_anomaly,
              "config": {k: (list(v) if isinstance(v, tuple) else v)
                         for k, v in chip_smoke.WIDE_TRAIN.items()}}
    paths = {"graph": graph_path, "host": lambda: host_path(False),
             "host_prefetch": lambda: host_path(True)}
    for name in args.paths.split(","):
        one_epoch = paths[name]()
        one_epoch()                               # warm-up / capture
        torch.cuda.synchronize()
        t0 = time.monotonic()
        one_epoch()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            one_epoch()
            torch.cuda.synchronize()
        doc = _kernel_table(prof, args.steps, wall)
        doc["examples_per_s"] = cfg.batch_size / doc["wall_ms_per_tick"] * 1e3
        report[name] = doc
        _print(f"train {name}", doc, card, top=30)
        print(f"[train {name}] {doc['examples_per_s']:.1f} examples/s at "
              f"global batch {cfg.batch_size}")
        del one_epoch
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
