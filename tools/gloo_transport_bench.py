"""Milliseconds per gloo collective for ranks that share one card: the
all_gather of a CUDA tensor as gloo runs it (``direct``) against the same
all_gather staged through pinned host memory (``staged``: a copy to the
host, gloo on the host tensors, a copy back), as parallel/distributed.py
would run it.

    python tools/gloo_transport_bench.py [--ranks 4] [--tp 2]

starts ``--ranks`` ranks by torchrun on card 0, splits them into process
groups of ``--tp`` (the tensor-parallel lines of run T's dp 2 x tp 2), and
times, in every group at once, all_gathers of the partials the training
step and run S gather (run T1's (1, 3,250, 3,072) bf16, run S's (2, 6,665,
3,072) bf16), each way in turns (direct, staged, staged, direct).  Prints
one JSON line with each size's ms per call, per way, from rank 0.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from datetime import timedelta

SHAPES = {"run T1 partial": (1, 3250, 3072), "run S partial": (2, 6665, 3072)}
CALLS = 20


def rank_main(tp: int) -> None:
    import torch
    import torch.distributed as dist

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", timeout=timedelta(seconds=300))
    groups = [dist.new_group(list(range(g, g + tp))) for g in range(0, world, tp)]
    group = groups[rank // tp]

    def direct(x):
        pieces = [torch.empty_like(x) for _ in range(tp)]
        dist.all_gather(pieces, x, group=group)
        return torch.cat(pieces)

    def staged(x):
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        pieces = [torch.empty_like(host) for _ in range(tp)]
        dist.all_gather(pieces, host, group=group)
        return torch.cat(pieces).to(x.device)

    out = {}
    for label, shape in SHAPES.items():
        x = torch.randn(shape, device="cuda").bfloat16()
        if not torch.equal(direct(x).cpu(), staged(x).cpu()):
            raise AssertionError("the staged all_gather differs from the direct one")
        times = {"direct": [], "staged": []}
        for way in ("direct", "staged", "staged", "direct"):
            fn = direct if way == "direct" else staged
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(CALLS):
                fn(x)
            torch.cuda.synchronize()
            times[way].append((time.perf_counter() - t0) / CALLS * 1e3)
        out[label] = {"shape": list(shape), "mb": x.numel() * 2 / 1e6,
                      **{way: [round(t, 2) for t in ts] for way, ts in times.items()}}
    if rank == 0:
        print(json.dumps({"gloo_all_gather_ms": out, "ranks": world, "tp": tp}), flush=True)
    dist.destroy_process_group()


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--tp", type=int, default=2)
    args = p.parse_args()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(args.ranks), __file__, "--rank", str(args.tp)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    lines = [line for line in proc.stdout.splitlines() if line.startswith("{")]
    if proc.returncode or not lines:
        raise SystemExit(f"torchrun rc {proc.returncode}: {proc.stderr[-3000:]}")
    print(lines[-1], flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(int(sys.argv[2]))
    else:
        main()
