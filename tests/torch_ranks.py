"""Launch the port's merge ranks as gloo processes on localhost, the way
``torchrun`` starts them (the ``env://`` rendezvous variables), for the
multi-rank CPU tests (tests/test_torch_parallel.py,
tests/test_torch_multihost.py, tests/test_torch_tp.py,
tests/test_torch_serve.py). Imports nothing of JAX."""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path
from typing import List, Sequence, Tuple

REPO = Path(__file__).resolve().parent.parent


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(argv: Sequence[str], world: int, logs: Path, env: dict = None) -> List[subprocess.Popen]:
    """Start ``python argv`` as ranks 0..world-1 of one group, each rank's
    stdout and stderr in ``logs``; returns the processes (not waited for)."""
    logs.mkdir(parents=True, exist_ok=True)
    port = free_port()
    procs = []
    for rank in range(world):
        rank_env = {
            **os.environ,
            "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(port),
            "WORLD_SIZE": str(world),
            "RANK": str(rank),
            "LOCAL_RANK": str(rank),
            "LOCAL_WORLD_SIZE": str(world),
            "PYTHONPATH": os.pathsep.join(filter(None, [str(REPO), os.environ.get("PYTHONPATH")])),
            "OMP_NUM_THREADS": "1",
            **(env or {}),
        }
        with open(logs / f"rank{rank}.out", "w") as out, open(logs / f"rank{rank}.err", "w") as err:
            procs.append(subprocess.Popen([sys.executable, *argv], env=rank_env, cwd=str(REPO), stdout=out,
                                          stderr=err))
    return procs


def wait(procs, logs: Path, timeout: float) -> List[Tuple[int, str, str]]:
    """Each rank's (exit code, stdout, stderr); a rank still running at
    ``timeout`` (a hang) is killed, with every other, and its code is None."""
    results = []
    for rank, proc in enumerate(procs):
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            rc = None
        results.append((rc, (logs / f"rank{rank}.out").read_text(), (logs / f"rank{rank}.err").read_text()))
    for p in procs:
        p.wait()
    return results


def launch(argv: Sequence[str], world: int, logs: Path, timeout: float = 240.0,
           env: dict = None) -> List[Tuple[int, str, str]]:
    """Run ``python argv`` as ranks 0..world-1 of one group; returns each
    rank's (exit code, stdout, stderr). A rank still running at ``timeout``
    (a hang) is killed, and its code is reported as None."""
    return wait(start(argv, world, logs, env), logs, timeout)
