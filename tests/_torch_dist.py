"""Shared pieces of the port's multi-process tests: a coordinator port and
a group of ranks run as processes, each on the CPU with one torch thread
(``OMP_NUM_THREADS=1`` from ``_torch_cpu``)."""

import os
import random
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")

# seconds a group of test ranks may take before it is killed
RANKS_TIMEOUT_S = 240


def coordinator_port() -> int:
    """A bind-tested free port below the kernel's ephemeral range, as
    tests/test_distributed.py picks one: a port handed to the ranks as a
    bare number must not be taken meanwhile by an outbound socket."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            floor = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        floor = 32768
    lo, hi = max(10240, floor - 22000), floor
    for _ in range(64):
        port = random.randrange(lo, hi)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(port: int, world: int, rank: int, **extra) -> dict:
    """This environment with PYTHONPATH at the repository and the
    PIO_TPU_* variables of rank ``rank`` of ``world``."""
    env = {k: v for k, v in os.environ.items()
           if k != "PYTHONPATH" and not k.startswith("PIO_TPU_")}
    return env | {"PYTHONPATH": f"{REPO}{os.pathsep}{TESTS}",
                  "PIO_TPU_COORDINATOR": f"127.0.0.1:{port}",
                  "PIO_TPU_NUM_PROCESSES": str(world),
                  "PIO_TPU_PROCESS_ID": str(rank),
                  "PIO_TPU_COORDINATOR_TIMEOUT_S": "60"} | extra


def run_ranks(argv_of, world: int, env_of=None, cwd=REPO,
              timeout: float = RANKS_TIMEOUT_S) -> list:
    """Start ``world`` processes at once, rank r running ``argv_of(r)``
    with ``rank_env`` (plus ``env_of(r)``); -> [(rc, stdout, stderr)] by
    rank. Every process is killed if the group outlives ``timeout``."""
    port = coordinator_port()
    procs = [subprocess.Popen(
        [sys.executable, *argv_of(r)], cwd=cwd, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=rank_env(port, world, r, **(env_of(r) if env_of else {})))
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs
