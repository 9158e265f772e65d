"""Start the ranks of a process group on this host, as subprocesses.

`spawn_ranks(world, python_args)` runs `python *python_args` once per rank
with the environment that `torchrun` sets (RANK, LOCAL_RANK, WORLD_SIZE,
LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT) and the package importable, so
each process joins the group through `mesh.init_distributed`, at a store
that this process holds for them (`mesh.rank_store`). Each spawn has
its own timeout: a rank that fails or outlives it ends every rank, and the
call raises with the ranks' output, so a dead rank never leaves the others
waiting in a collective. A rank's process group ends before its process
does (`mesh.init_distributed`).
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
from typing import List, Mapping, Optional

from facodec_tpu_torch.parallel.mesh import rank_store

PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
END_GRACE_S = 5.0  # after a rank fails, the others' time to end by themselves


def spawn_ranks(world: int, python_args: List[str], timeout: float = 600.0,
                env: Optional[Mapping[str, str]] = None) -> List[str]:
    """Run `python *python_args` as `world` ranks on this host (RANK,
    LOCAL_RANK, WORLD_SIZE, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT set,
    the package importable), e.g. `["-m", "facodec_tpu_torch", "train",
    "--device", "cpu"]`; returns each rank's output. A rank that exits
    non-zero (after END_GRACE_S for the others to end by themselves), or
    any rank still running after `timeout` seconds, ends them all and
    raises with their output."""
    base = dict(os.environ, **(env or {}))
    base["PYTHONPATH"] = os.pathsep.join(p for p in (PACKAGE_ROOT, base.get("PYTHONPATH"))
                                         if p)
    base.update(WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world))
    with rank_store() as store_env:
        return _run_ranks(world, python_args, timeout, dict(base, **store_env))


def _run_ranks(world: int, python_args: List[str], timeout: float,
               base: Mapping[str, str]) -> List[str]:
    logs = [open(_log_path(r), "w+") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, *python_args],
                              env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=logs[r], stderr=subprocess.STDOUT, cwd=PACKAGE_ROOT)
             for r in range(world)]
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                failed = "a rank failed"
                # the others' collectives fail once its group is gone: their
                # own exit codes say more than a kill's, so wait a moment
                grace = time.monotonic() + END_GRACE_S
                while any(p.poll() is None for p in procs) and time.monotonic() < grace:
                    time.sleep(0.05)
                break
            if time.monotonic() > deadline:
                failed = f"ranks still running after {timeout:.0f} s"
                break
            time.sleep(0.05)
        else:
            if any(p.returncode != 0 for p in procs):
                failed = "a rank failed"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outputs = []
    for f in logs:
        f.seek(0)
        outputs.append(f.read())
        f.close()
        os.unlink(f.name)
    if failed:
        codes = [p.returncode for p in procs]
        raise RuntimeError(f"spawn_ranks: {failed}, exit codes {codes}\n" + "\n".join(
            f"--- rank {r} ---\n{o[-4000:]}" for r, o in enumerate(outputs)))
    return outputs


def _log_path(rank: int) -> str:
    fd, path = tempfile.mkstemp(prefix=f"facodec-rank{rank}-", suffix=".log")
    os.close(fd)
    return path
