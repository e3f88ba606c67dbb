"""Multi-process runner: the port of
``distributed_tensorflow_examples_tpu/utils/multiprocess.py`` (the
reference's ``MultiProcessRunner``).

Starts one real OS process per cluster task, hands each its identity in
``TF_CONFIG`` (so ``parallel.dist`` resolves the world as a reference
launcher's process would), captures each task's output, and can kill a
task mid-run (the fault-injection primitive).  Task scripts are plain
Python source; by default each runs after a prelude that joins the
process group (``dist.initialize(device=...)``), so the body sees a live
world: gloo ranks on the CPU, or ranks on the card.  With
``prelude=False`` the script joins itself (an example CLI's
``Experiment`` does)::

    r = MultiProcessRunner(2, "print(dist.process_index())", device="cpu")
    outputs = r.run()       # or r.start(); ...; r.join()
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_PRELUDE = """\
import sys
sys.path.insert(0, {repo_root!r})
from distributed_tensorflow_examples_tpu_torch.parallel import dist
_cluster = dist.initialize(device={device!r})
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class MultiProcessRunner:
    """``num_processes`` copies of ``worker_src`` as one ``TF_CONFIG``
    cluster of workers on this host, the coordinator at
    ``localhost:<free port>``."""

    def __init__(
        self,
        num_processes: int,
        worker_src: str,
        *,
        env: dict[str, str] | None = None,
        timeout: float = 120.0,
        prelude: bool = True,
        device: str | None = "cpu",
    ):
        """``device`` is the prelude's request (``"cpu"``, or None for the
        card); ``env`` is added to every task's environment."""
        self.n = num_processes
        self.timeout = timeout
        self.port = free_port()
        self._dir = tempfile.mkdtemp(prefix="dtx_mp_")
        header = (
            _PRELUDE.format(repo_root=_REPO_ROOT, device=device) if prelude
            else f"import sys\nsys.path.insert(0, {_REPO_ROOT!r})\n"
        )
        self.script_path = os.path.join(self._dir, "worker.py")
        with open(self.script_path, "w") as f:
            f.write(header + worker_src)
        self.extra_env = dict(env or {})
        self.procs: list[subprocess.Popen] = []
        self.log_paths: list[str] = []
        self._log_files: list = []

    def tf_config(self, index: int) -> str:
        """Task ``index``'s ``TF_CONFIG``: every entry carries the
        coordinator's port (only rank 0 binds it)."""
        return json.dumps({
            "cluster": {"worker": [f"localhost:{self.port}"] * self.n},
            "task": {"type": "worker", "index": index},
        })

    def start(self) -> None:
        for i in range(self.n):
            env = dict(os.environ)
            env["TF_CONFIG"] = self.tf_config(i)
            env.update(self.extra_env)
            log_path = os.path.join(self._dir, f"task_{i}.log")
            self.log_paths.append(log_path)
            logf = open(log_path, "w")
            self._log_files.append(logf)
            self.procs.append(subprocess.Popen(
                [sys.executable, self.script_path, str(i)], env=env, stdout=logf,
                stderr=subprocess.STDOUT,
            ))

    def kill_task(self, index: int, sig: int = signal.SIGKILL) -> None:
        """Fault injection: signal one task."""
        self.procs[index].send_signal(sig)

    def join(self, timeout: float | None = None) -> list[int]:
        """Wait for every task; returns their exit codes (negative: killed
        by a signal).  Tasks still running at the timeout are killed and
        reported as -9."""
        deadline = time.monotonic() + (timeout or self.timeout)
        codes: list[int | None] = [None] * self.n
        while time.monotonic() < deadline and any(c is None for c in codes):
            for i, p in enumerate(self.procs):
                if codes[i] is None:
                    codes[i] = p.poll()
            time.sleep(0.05)
        for i, p in enumerate(self.procs):
            if codes[i] is None:
                p.kill()
                p.wait()
                codes[i] = -9
        for f in self._log_files:
            f.close()
        self._log_files.clear()
        return [int(c) for c in codes]

    def output(self, index: int) -> str:
        with open(self.log_paths[index]) as f:
            return f.read()

    def cleanup(self) -> None:
        """Remove the script and log directory (kept on failure)."""
        shutil.rmtree(self._dir, ignore_errors=True)

    def run(self) -> list[str]:
        """start + join; raises with every task's output if any failed;
        returns each task's output."""
        self.start()
        codes = self.join()
        if any(c != 0 for c in codes):
            logs = "\n".join(
                f"--- task {i} (exit {codes[i]}) ---\n{self.output(i)}" for i in range(self.n)
            )
            raise RuntimeError(f"multi-process run failed: {codes}\n{logs}")
        outs = [self.output(i) for i in range(self.n)]
        self.cleanup()
        return outs
