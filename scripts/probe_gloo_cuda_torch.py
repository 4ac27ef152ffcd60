#!/usr/bin/env python3
"""Which torch.distributed collectives the gloo backend carries for CUDA
tensors when two ranks share one card, each operation in its own pair of
processes (a refused one can abort its process: gloo's TCP transport
writes from the device pointer), and whether NCCL takes two ranks of
one communicator on one card.

    python3 scripts/probe_gloo_cuda_torch.py [--out runs/gloo_probe.json]

The port's parallel/mesh passes CUDA tensors to gloo's all_reduce,
broadcast and all_gather, found to work, and stages send and recv
through host memory.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile

OPS = ("all_reduce", "all_reduce_bf16", "broadcast", "broadcast_bf16",
       "all_gather", "send_recv")


def rank_body(op, rank, store, backend):
    import torch
    import torch.distributed as dist

    dist.init_process_group(backend, init_method=f"file://{store}",
                            world_size=2, rank=rank)
    torch.cuda.set_device(0)
    dev = torch.device("cuda:0")
    dt = torch.bfloat16 if op.endswith("bf16") else torch.float32
    x = torch.full((4096,), float(rank + 1), device=dev, dtype=dt)
    if op.startswith("all_reduce"):
        dist.all_reduce(x)
        ok = float(x[0]) == 3.0
    elif op.startswith("broadcast"):
        dist.broadcast(x, 0)
        ok = float(x[0]) == 1.0
    elif op == "all_gather":
        parts = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(parts, x)
        ok = float(parts[0][0]) == 1.0 and float(parts[1][0]) == 2.0
    else:
        if rank == 0:
            dist.send(x, 1)
            ok = True
        else:
            dist.recv(x, 0)
            ok = float(x[0]) == 1.0
    torch.cuda.synchronize()
    dist.destroy_process_group()
    print(json.dumps({"ok": bool(ok)}), flush=True)


def run_pair(op, backend):
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--rank", str(r), "--op", op,
             "--store", store, "--backend", backend],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(2)]
        res = []
        for p in procs:
            try:
                out, err = p.communicate(timeout=120)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                return {"works": False, "why": "timed out"}
            res.append((p.returncode, out, err))
    works = all(rc == 0 and '"ok": true' in out for rc, out, _ in res)
    why = "" if works else next(
        (e.strip().splitlines()[-1] if e.strip() else f"exit {rc}")
        for rc, out, e in res if rc != 0 or '"ok": true' not in out)
    return {"works": works, "why": why[:300]}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=None)
    p.add_argument("--rank", type=int, default=None)
    p.add_argument("--op", default=None)
    p.add_argument("--store", default=None)
    p.add_argument("--backend", default="gloo")
    a = p.parse_args()
    if a.rank is not None:
        rank_body(a.op, a.rank, a.store, a.backend)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    result = {"torch": torch.__version__,
              "device": torch.cuda.get_device_name(0),
              "gloo": {op: run_pair(op, "gloo") for op in OPS},
              "nccl_two_ranks_one_card": run_pair("all_reduce", "nccl")}
    print(json.dumps(result, indent=1), flush=True)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
