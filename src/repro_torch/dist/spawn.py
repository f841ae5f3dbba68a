"""Ranks as processes: run one function on every rank of a fresh world.

    results = spawn.run("package.module:function", world=4,
                        backend="gloo", args=(...,), timeout=120)

starts `world` Python processes (`python -m repro_torch.dist.spawn`),
each of which joins a process group through a `file://` store in a
private temporary directory (no port to collide with), calls
`function(*args)` and writes what it returns with `torch.save`. `run`
returns the ranks' results in rank order. A rank that exits non-zero,
or a world that outlasts `timeout` seconds, kills every rank and raises
`RuntimeError` with the end of each rank's output — a hung rank fails
its caller and never hangs it.

Each rank sets `torch.set_num_threads(1)` before it imports the
target. On the card every rank uses `cuda:<local rank % devices>`:
with one card the ranks share it (gloo, since NCCL refuses two ranks
on one device); on a world of distinct cards pass `backend="nccl"`.
The child's `PYTHONPATH` is the caller's plus `paths`, so targets
outside the package (a test module, a script) import in the child.
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys
import tempfile
import time
from typing import Any, List, Sequence

import torch


def run(target: str, world: int, *, backend: str = "gloo",
        args: Sequence[Any] = (), timeout: float = 120.0,
        paths: Sequence[str] = ()) -> List[Any]:
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        torch.save(tuple(args), os.path.join(tmp, "args.pt"))
        child_env = dict(os.environ)
        extra = [os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))] + [os.path.abspath(p) for p in paths]
        child_env["PYTHONPATH"] = os.pathsep.join(
            extra + [p for p in child_env.get("PYTHONPATH", "").split(
                os.pathsep) if p])
        procs, logs = [], []
        for rank in range(world):
            log = open(os.path.join(tmp, f"rank{rank}.log"), "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.dist.spawn", target,
                 str(rank), str(world), backend, tmp],
                env=child_env, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        failed = None
        try:
            while any(p.poll() is None for p in procs):
                bad = [r for r, p in enumerate(procs)
                       if p.poll() not in (None, 0)]
                if bad:
                    failed = f"rank {bad[0]} exited {procs[bad[0]].poll()}"
                    break
                if time.monotonic() > deadline:
                    failed = f"ranks still running after {timeout} s"
                    break
                time.sleep(0.05)
            else:
                bad = [r for r, p in enumerate(procs) if p.returncode != 0]
                if bad:
                    failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
            for log in logs:
                log.close()
        outputs = []
        for rank in range(world):
            with open(os.path.join(tmp, f"rank{rank}.log")) as f:
                outputs.append(f.read())
        if failed:
            tails = "\n".join(f"--- rank {r} ---\n{out[-3000:]}"
                              for r, out in enumerate(outputs))
            raise RuntimeError(f"{target} on {world} ranks: {failed}\n{tails}")
        results = [torch.load(os.path.join(tmp, f"result{rank}.pt"),
                              weights_only=False) for rank in range(world)]
    for rank, out in enumerate(outputs):
        for line in out.splitlines():
            print(f"[rank {rank}] {line}", flush=True)
    return results


def _child(target: str, rank: int, world: int, backend: str, tmp: str
           ) -> None:
    # ranks share the host's cores with each other and with their caller
    torch.set_num_threads(1)
    import torch.distributed as dist

    if torch.cuda.is_available():
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world)
    try:
        module, name = target.split(":")
        fn = getattr(importlib.import_module(module), name)
        args = torch.load(os.path.join(tmp, "args.pt"), weights_only=False)
        result = fn(*args)
        torch.save(result, os.path.join(tmp, f"result{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
           sys.argv[5])
