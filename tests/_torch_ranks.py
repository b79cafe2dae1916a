"""Start the ranks of a multi-rank CPU test as processes of their own and
wait for them, each wait with its own timeout; a rank that outlives it is
killed, and the test fails with every rank's log."""

import os
import signal
import subprocess
import sys
from pathlib import Path

from demucs_tpu_torch.parallel import free_port

REPO = Path(__file__).resolve().parent.parent


def run_ranks(script: Path, world: int, *args: str, timeout: float = 240.0,
              expect: int = 0) -> list[str]:
    """Run `python script RANK WORLD PORT *args` for each rank at a free
    port, torch held to one thread a process, each rank in a session of
    its own (a timed-out rank is killed with every process it started);
    returns the ranks' logs and asserts that every rank exited `expect`."""
    port = str(free_port())
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(world), port, *args],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=str(REPO),
                              env=env, start_new_session=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()
    for r, p in enumerate(procs):
        assert p.returncode == expect, f"rank {r} exited {p.returncode}:\n" + "\n".join(
            f"--- rank {i}:\n{log[-3000:]}" for i, log in enumerate(logs))
    return logs
