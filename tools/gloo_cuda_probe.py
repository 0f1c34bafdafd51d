"""Which torch.distributed operations the gloo backend runs on CUDA tensors,
between two ranks that share one card (parallel/distributed.py stages the
others through host memory: ``GLOO_CUDA_OPS``).

    python tools/gloo_cuda_probe.py

starts, for each operation, two ranks by torchrun on card 0 that run it once
on a CUDA tensor, and prints one JSON line: per operation "runs" (and the
result checked), or how the ranks ended (an unsupported operation may end
the process inside gloo rather than raise).  Each run is limited to 120 s.
"""

import json
import os
import subprocess
import sys
from datetime import timedelta

OPS = ("all_reduce", "broadcast", "all_gather", "send_recv", "batch_isend_irecv")


def run_op(name: str) -> None:
    import torch
    import torch.distributed as dist

    rank = int(os.environ["RANK"])
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", timeout=timedelta(seconds=30))
    x = torch.full((1024,), float(rank + 1), device="cuda")
    peer = 1 - rank
    if name == "all_reduce":
        y = x.clone()
        dist.all_reduce(y)
        ok = bool((y == 3.0).all())
    elif name == "broadcast":
        y = x.clone()
        dist.broadcast(y, 0)
        ok = bool((y == 1.0).all())
    elif name == "all_gather":
        ys = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(ys, x)
        ok = bool((ys[peer] == peer + 1.0).all())
    elif name == "send_recv":
        y = torch.empty_like(x)
        dist.send(x, peer) if rank == 0 else dist.recv(y, peer)
        ok = rank == 0 or bool((y == 1.0).all())
    else:
        y = torch.empty_like(x)
        for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, peer),
                                         dist.P2POp(dist.irecv, y, peer)]):
            w.wait()
        ok = bool((y == peer + 1.0).all())
    torch.cuda.synchronize()
    print(json.dumps({"rank": rank, "ok": ok}), flush=True)
    dist.destroy_process_group()


def main() -> None:
    result = {}
    for name in OPS:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "2", __file__, name]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        except subprocess.TimeoutExpired:
            result[name] = "no end within 120 s"
            continue
        oks = [json.loads(line)["ok"] for line in proc.stdout.splitlines()
               if line.startswith('{"rank"')]
        if proc.returncode == 0 and len(oks) == 2:
            result[name] = "runs" if all(oks) else "runs, wrong result"
        else:
            errors = [line.strip() for line in proc.stderr.splitlines()
                      if "what()" in line or "Error" in line]
            result[name] = f"fails (rc {proc.returncode}): " + (errors[0][:200] if errors else "")
    print(json.dumps({"gloo_on_cuda": result}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 1:
        run_op(sys.argv[1])
    else:
        main()
