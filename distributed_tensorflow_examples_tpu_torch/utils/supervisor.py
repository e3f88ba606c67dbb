"""Per-task supervisor: the port of
``distributed_tensorflow_examples_tpu/utils/supervisor.py``, the
whole-job crash-restart half of fault recovery.

Detection is ``parallel.dist.start_watchdog``: when a peer's heartbeat
stops, every surviving rank exits ``EXIT_PEER_LOST`` (83) rather than
hang in its next all-reduce.  Restart is this module: each cluster task
runs under :func:`supervise`, which relaunches its child with the same
environment (the same ``TF_CONFIG``, the same flags) whenever it exits
non-zero; the process group re-forms over the fixed set of ranks, and
``TrainSession`` auto-resumes from the last checkpoint.  A single rank
does not rejoin a live group: a group is formed over a fixed set of
processes (as the reference was not elastic either).

Usage (one per cluster task)::

    python -m distributed_tensorflow_examples_tpu_torch.utils.supervisor \
        --max_restarts=3 -- python -m \
        distributed_tensorflow_examples_tpu_torch.examples.mnist_mlp --log_dir=...
"""

from __future__ import annotations

import logging
import os
import subprocess
import sys
import time

log = logging.getLogger("dtx.supervisor")


def supervise(
    argv: list[str],
    *,
    max_restarts: int = 3,
    backoff_s: float = 1.0,
    env: dict[str, str] | None = None,
) -> int:
    """Run ``argv`` as a child process, restarting it on nonzero exit.

    Returns the final exit code: 0 on eventual success, the child's last
    code once ``max_restarts`` is exhausted.  Each restart logs the incident
    and waits ``backoff_s`` (linearly growing) so all tasks of a job have
    time to die before the new incarnation forms.

    SIGTERM/SIGINT to the supervisor are forwarded to the child and end
    supervision (no restart): killing the supervised task's visible pid
    must kill the real server underneath, not orphan it.
    """
    import signal as _signal

    child: list[subprocess.Popen | None] = [None]
    terminated = [False]

    def _forward(signum, frame):
        terminated[0] = True
        p = child[0]
        if p is not None and p.poll() is None:
            try:
                p.send_signal(signum)
            except (ProcessLookupError, OSError):
                pass

    old_handlers = {}
    for sig in (_signal.SIGTERM, _signal.SIGINT):
        try:
            old_handlers[sig] = _signal.signal(sig, _forward)
        except (ValueError, OSError):  # non-main thread: keep defaults
            pass

    attempt = 0
    returncode = 0
    try:
        while True:
            if terminated[0]:
                # Signal landed while no child was running (backoff window):
                # honor it instead of spawning an incarnation it can't reach.
                log.info("supervise: terminated by signal; not restarting")
                return returncode or 130
            proc = subprocess.Popen(argv, env=env)
            child[0] = proc
            if terminated[0] and proc.poll() is None:
                # Signal raced the spawn (before child[0] was visible to
                # the handler): forward it by hand.
                proc.terminate()
            returncode = proc.wait()
            child[0] = None
            if terminated[0]:
                log.info("supervise: terminated by signal; not restarting")
                return returncode
            if returncode == 0:
                if attempt:
                    log.info(
                        "supervise: child succeeded after %d restart(s)", attempt
                    )
                return 0
            if attempt >= max_restarts:
                log.error(
                    "supervise: child exited %d; restart budget (%d) exhausted",
                    returncode,
                    max_restarts,
                )
                return returncode
            attempt += 1
            delay = backoff_s * attempt
            log.warning(
                "supervise: child exited %d; restart %d/%d in %.1fs "
                "(whole-job crash-restart — training auto-resumes from the "
                "last checkpoint)",
                returncode,
                attempt,
                max_restarts,
                delay,
            )
            time.sleep(delay)
    finally:
        for sig, handler in old_handlers.items():
            try:
                _signal.signal(sig, handler)
            except (ValueError, OSError):
                pass


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    max_restarts, backoff = 3, 1.0
    while argv and argv[0].startswith("--"):
        flag = argv.pop(0)
        if flag == "--":
            break
        key, has_eq, val = flag.lstrip("-").partition("=")
        if key not in ("max_restarts", "backoff_s"):
            print(f"supervisor: unknown flag {flag!r}", file=sys.stderr)
            return 2
        if not has_eq:  # space-separated form: --max_restarts 3
            if not argv:
                print(f"supervisor: flag {flag!r} needs a value", file=sys.stderr)
                return 2
            val = argv.pop(0)
        try:
            if key == "max_restarts":
                max_restarts = int(val)
            else:
                backoff = float(val)
        except ValueError:
            print(f"supervisor: bad value for {flag!r}: {val!r}", file=sys.stderr)
            return 2
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    return supervise(argv, max_restarts=max_restarts, backoff_s=backoff, env=dict(os.environ))


if __name__ == "__main__":
    sys.exit(main())
