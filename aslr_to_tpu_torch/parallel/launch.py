"""Start a process a device on this host, for the sharded solve at once.

    python -m aslr_to_tpu_torch.parallel.launch --nproc-per-node N [--timeout S] \
        -m MODULE [ARGS ...]
    python -m aslr_to_tpu_torch.parallel.launch --nproc-per-node N [--timeout S] \
        SCRIPT [ARGS ...]

starts N copies of ``python -m MODULE ARGS`` (or ``python SCRIPT ARGS``),
each with the environment that ``torchrun --nproc-per-node=N`` gives it:
``RANK`` and ``LOCAL_RANK`` (0 .. N-1), ``WORLD_SIZE`` and
``LOCAL_WORLD_SIZE`` (N), ``MASTER_ADDR=localhost`` and ``MASTER_PORT``, a
free port picked at each launch, and ``OMP_NUM_THREADS=1`` unless it is
set. So :func:`.mesh.distributed_init` with no
arguments joins them, and the same program runs under ``torchrun``. Each
line a process prints is echoed as ``[rank r] ...``. The launch fails, and
every process still running is killed, as soon as one exits non-zero or
when the timeout (every process's own, counted from the start) has passed;
the command then exits 1.

The same from Python: :func:`run` (the outputs, or :class:`LaunchError`),
or :class:`Ranks` for a caller that talks to the processes as they run.
"""
from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

# the directory that holds the package, put on each process's PYTHONPATH so
# that ``-m aslr_to_tpu_torch....`` imports this checkout wherever it runs
_ROOT = str(Path(__file__).resolve().parents[2])


class LaunchError(RuntimeError):
    """A process of the launch exited non-zero or overran its timeout."""


def free_port() -> int:
    """A TCP port of localhost that no one listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Ranks:
    """``n`` processes ``python *argv`` started together as the ranks of one
    group (the environment above), each with ``timeout`` seconds from now.
    Their output (stdout and stderr together) is read line by line as it
    comes (``lines[r]``; echoed with its rank when ``echo``). With
    ``stdin`` each reads what :meth:`send` writes. Use it as a context
    manager: leaving it kills every process still running."""

    def __init__(self, n: int, argv, timeout: float, env=None, stdin: bool = False,
                 echo: bool = False):
        if n < 1:
            raise ValueError(f"a launch needs at least one process, got {n}")
        self.deadline = time.monotonic() + timeout
        self.timeout = timeout
        self.lines = [[] for _ in range(n)]
        self.procs = []
        self._cond = threading.Condition()
        self._readers = []
        base = dict(os.environ if env is None else env)
        base["PYTHONPATH"] = os.pathsep.join(p for p in (_ROOT, base.get("PYTHONPATH")) if p)
        # as torchrun does: one intra-op thread a rank unless the caller says
        base.setdefault("OMP_NUM_THREADS", "1")
        base.update(WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="localhost",
                    MASTER_PORT=str(free_port()))
        try:
            for r in range(n):
                proc = subprocess.Popen(
                    [sys.executable, *argv], env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
                    stdin=subprocess.PIPE if stdin else subprocess.DEVNULL,
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, bufsize=1)
                self.procs.append(proc)
                reader = threading.Thread(target=self._read, args=(r, proc, echo), daemon=True)
                reader.start()
                self._readers.append(reader)
        except BaseException:
            self.kill()
            raise

    def _read(self, r, proc, echo):
        for line in proc.stdout:
            line = line.rstrip("\n")
            with self._cond:
                if echo:
                    sys.stdout.write(f"[rank {r}] {line}\n")
                    sys.stdout.flush()
                self.lines[r].append(line)
                self._cond.notify_all()
        with self._cond:
            self._cond.notify_all()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.kill()

    def kill(self):
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()

    def output(self, r: int) -> str:
        with self._cond:
            return "\n".join(self.lines[r])

    def _fail(self, why: str):
        self.kill()
        for reader in self._readers:
            reader.join(timeout=5)
        tails = "\n".join(f"--- rank {r} (exit {p.returncode}):\n"
                          + "\n".join(self.lines[r][-40:]) for r, p in enumerate(self.procs))
        raise LaunchError(f"{why}\n{tails}")

    def _check(self):
        """Raise (and kill every process) if one exited non-zero or the
        timeout has passed."""
        failed = [r for r, p in enumerate(self.procs) if p.poll() not in (None, 0)]
        if failed:
            self._fail(f"rank(s) {failed} exited non-zero")
        if time.monotonic() > self.deadline:
            self._fail(f"the launch overran its timeout of {self.timeout} s")

    def wait_for(self, prefix: str) -> list[str]:
        """Each rank's first line that starts with ``prefix``, once every
        rank has printed one; raises if a rank fails, ends without it or
        overruns."""
        while True:
            with self._cond:
                found = [next((ln for ln in lines if ln.startswith(prefix)), None)
                         for lines in self.lines]
                if all(f is not None for f in found):
                    return found
                self._cond.wait(0.05)
            self._check()
            ended = [r for r, (p, f) in enumerate(zip(self.procs, found))
                     if f is None and p.poll() == 0]
            if ended:
                self._fail(f"rank(s) {ended} ended without printing {prefix!r}")

    def send(self, text: str):
        """Write ``text`` to every process's standard input."""
        for proc in self.procs:
            proc.stdin.write(text)
            proc.stdin.flush()

    def wait(self) -> list[str]:
        """Each rank's whole output, once all have exited 0; raises if one
        fails or the timeout passes."""
        while any(p.poll() is None for p in self.procs):
            self._check()
            time.sleep(0.05)
        self._check()
        for reader in self._readers:
            reader.join(max(0.0, self.deadline - time.monotonic()))
        return [self.output(r) for r in range(len(self.procs))]


def run(n: int, argv, timeout: float, env=None, echo: bool = False) -> list[str]:
    """Start ``n`` ranks of ``python *argv`` and wait for them: each rank's
    output, or :class:`LaunchError` if one exits non-zero or the launch
    overruns ``timeout`` seconds (every process is killed then)."""
    with Ranks(n, argv, timeout, env=env, echo=echo) as ranks:
        return ranks.wait()


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(
        prog="python -m aslr_to_tpu_torch.parallel.launch",
        description="Start N ranks of a Python program on this host (torchrun's environment).")
    ap.add_argument("--nproc-per-node", "--nproc", type=int, required=True,
                    help="the processes to start: one a card")
    ap.add_argument("--timeout", type=float, default=3600.0,
                    help="seconds each process may run (default 3600)")
    # the launcher's options end where the program's command begins
    i = 0
    while i < len(argv) and argv[i].startswith("--"):
        i += 1 if "=" in argv[i] else 2
    opts, command = ap.parse_args(argv[:i]), argv[i:]
    if not command:
        ap.error("name the program: -m MODULE [ARGS ...] or SCRIPT [ARGS ...]")
    try:
        run(opts.nproc_per_node, command, opts.timeout, echo=True)
    except LaunchError as e:
        print(f"launch failed: {e}", file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
