"""Which collectives a gloo group carries on CUDA tensors, two ranks on
one card, and how long a 64 MB all-reduce and a 32 MB ring rotation of
them take.

    python3 scripts/torch_gloo_cuda_probe.py [--mb 64] [--rotate_mb 32]
                                             [--reps 5]

NCCL refuses two ranks on one device, so the tensor-parallel phase of
``chip_smoke.py`` (5e) runs its two ranks over gloo, which stages CUDA
tensors through host memory.  This script starts two processes on the
card, joins them in a gloo group and tries, on CUDA tensors, each
collective the port's parallel code calls: ``all_reduce``,
``all_gather_into_tensor`` (``all_gather_single`` where torch has it),
``reduce_scatter_tensor`` (``reduce_scatter_single``), ``broadcast``,
``barrier``, and an ``all_reduce`` over a sub-group made by
``new_group``; each is checked against its expected value.  Then it
times ``--reps`` all-reduces of ``--mb`` MB of f32 on the host clock
(the first one untimed).

The sequence-parallel collectives each run in a pair of processes of
their own, so one that crashes a rank shows as its exit code and the
others still answer: ``send``/``recv``, ``batch_isend_irecv`` (the
ring's rotation over NCCL), ``all_to_all_single`` with equal splits
(Ulysses' exchange) and the rotation written as an
``all_to_all_single`` whose splits are 0 but the neighbour's (the
rotation ``parallel/mesh.seq_rotate`` runs over gloo).  Each that
answers right times ``--reps`` rotations of ``--rotate_mb`` MB of bf16
(the first one untimed).  Prints the card's name and power limit, each
rank's answers, and one JSON line.  Needs one card.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys

RANK_PROGRAM = r'''
import json, sys, time
import torch
import torch.distributed as dist

rank, port, mb, reps, which = (int(sys.argv[1]), sys.argv[2],
                               int(sys.argv[3]), int(sys.argv[4]),
                               sys.argv[5])
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=rank)
out = {"rank": rank}


def attempt(name, fn):
    try:
        out[name] = "ok" if fn() else "wrong value"
    except Exception as e:
        out[name] = f"{type(e).__name__}: {e}"[:300]


def all_reduce():
    t = torch.full((4,), float(rank + 1), device="cuda")
    dist.all_reduce(t)
    return bool(torch.all(t == 3.0))


def all_gather():
    fn = (getattr(dist, "all_gather_single", None)
          or dist.all_gather_into_tensor)
    t = torch.full((3,), float(rank), device="cuda")
    o = torch.empty(6, device="cuda")
    fn(o, t)
    return o.tolist() == [0.0] * 3 + [1.0] * 3


def reduce_scatter():
    fn = (getattr(dist, "reduce_scatter_single", None)
          or dist.reduce_scatter_tensor)
    t = torch.arange(4, dtype=torch.float32, device="cuda")
    o = torch.empty(2, device="cuda")
    fn(o, t)
    return o.tolist() == [2.0 * (2 * rank), 2.0 * (2 * rank + 1)]


def broadcast():
    t = torch.full((2,), float(rank + 5), device="cuda")
    dist.broadcast(t, 0)
    return t.tolist() == [5.0, 5.0]


def sub_group():
    g = dist.new_group([0, 1])
    t = torch.ones(2, device="cuda")
    dist.all_reduce(t, group=g)
    return t.tolist() == [2.0, 2.0]


def send_recv(t):
    o = torch.empty_like(t)
    if rank == 0:
        dist.send(t, 1)
        dist.recv(o, 1)
    else:
        dist.recv(o, 0)
        dist.send(t, 0)
    return o


def batch_isend_irecv(t):
    o = torch.empty_like(t)
    ops = [dist.P2POp(dist.isend, t, 1 - rank),
           dist.P2POp(dist.irecv, o, 1 - rank)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return o


def all_to_all(t):
    # equal splits: chunk i of the input goes to rank i
    o = torch.empty_like(t)
    dist.all_to_all_single(o, t)
    return o


def rotate_a2a(t):
    # all of t to the neighbour, all of the neighbour's back: every
    # split 0 but the neighbour's
    n = t.numel()
    o = torch.empty_like(t)
    splits = [n if i == 1 - rank else 0 for i in range(2)]
    dist.all_to_all_single(o.view(-1), t.view(-1), splits, splits)
    return o


ROTATIONS = {"send_recv": send_recv, "batch_isend_irecv": batch_isend_irecv,
             "all_to_all_single": all_to_all, "rotate_a2a": rotate_a2a}


def rotation_ok(fn):
    t = torch.arange(8, dtype=torch.float32, device="cuda") + 10 * rank
    o = fn(t)
    torch.cuda.synchronize()
    if fn is all_to_all:
        want = torch.cat([torch.arange(4, dtype=torch.float32) + 4 * rank
                          + 10 * r for r in range(2)])
    else:
        want = torch.arange(8, dtype=torch.float32) + 10 * (1 - rank)
    return bool(torch.equal(o.cpu(), want))


def timed(fn, t):
    fn(t)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        dist.barrier()
        t0 = time.perf_counter()
        fn(t)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


if which == "collectives":
    for name, fn in (("all_reduce", all_reduce), ("all_gather", all_gather),
                     ("reduce_scatter", reduce_scatter),
                     ("broadcast", broadcast),
                     ("barrier", lambda: dist.barrier() or True),
                     ("sub_group_all_reduce", sub_group)):
        attempt(name, fn)
    big = torch.ones(mb * 2 ** 20 // 4, device="cuda")
    out["all_reduce_ms"] = timed(lambda t: dist.all_reduce(t), big)
else:
    fn = ROTATIONS[which]
    attempt(which, lambda: rotation_ok(fn))
    if out[which] == "ok":
        # mb MB of bf16, the dtype the ring moves
        big = torch.ones(mb * 2 ** 20 // 2, dtype=torch.bfloat16,
                         device="cuda")
        out[which + "_ms"] = timed(fn, big)
dist.destroy_process_group()
print("RESULT " + json.dumps(out), flush=True)
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _pair(which: str, mb: int, reps: int) -> list:
    """One pair of rank processes running ``which``: each rank's answers,
    or its exit code and the tail of its output when it printed none."""
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_PROGRAM, str(r), port, str(mb),
         str(reps), which], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=dict(os.environ))
        for r in range(2)]
    ranks = []
    for p in procs:
        try:
            text = p.communicate(timeout=300)[0]
        except subprocess.TimeoutExpired:
            p.kill()
            text = p.communicate()[0]
        line = [ln for ln in text.splitlines() if ln.startswith("RESULT ")]
        ranks.append(json.loads(line[-1][7:]) if line
                     else {which: f"exit {p.returncode}",
                           "error": text[-600:]})
    return ranks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mb", type=int, default=64)
    ap.add_argument("--rotate_mb", type=int, default=32)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_gloo_cuda_probe: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    ranks = _pair("collectives", args.mb, args.reps)
    rotations = {w: _pair(w, args.rotate_mb, args.reps)
                 for w in ("send_recv", "batch_isend_irecv",
                           "all_to_all_single", "rotate_a2a")}
    for r in ranks:
        print(f"[gloo-cuda] {r}", flush=True)
    for w, pair in rotations.items():
        for r in pair:
            print(f"[gloo-cuda] {w}: {r}", flush=True)
    print(smi)
    print(json.dumps({"card": smi, "torch": torch.__version__,
                      "ranks": ranks, "rotations": rotations}))
    ok = all(r.get(k) == "ok" for r in ranks
             for k in ("all_reduce", "all_gather", "reduce_scatter"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
