"""Shared set-up of the port's multi-rank tests (``test_torch_pipeline``,
``_sharded_loader``, ``_checkpoint_reshard``, ``_moe_ep``,
``_train_mesh``): a group of gloo ranks on the CPU, as torchrun would
start them (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``). One subprocess imports torch once and forks a process a
rank before it has made a thread (``OMP_NUM_THREADS=1``, no op run, no
process group), so a group costs one interpreter's start-up, not one a
rank; the whole group runs under its own
timeout, so a hang fails one test instead of the run. The ranks import no
JAX: each test holds what they return against ``repro`` in its own
process."""
import json
import os
import socket
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the top of every rank's script: ``emit`` for what the rank returns (a
# JSON line on its stdout), and, unless the script makes it itself (the
# train launcher does), a process group over the environment
HEAD = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
RANK, WORLD = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])

def emit(obj):
    print("RANK_OUT " + json.dumps(obj), flush=True)
"""
PRELUDE = HEAD + """
dist.init_process_group("gloo")
"""

# the parent of the ranks: imports what every rank needs, forks them with
# their stdout and stderr in files, waits for all of them until the
# deadline, kills the rest, and prints their exit codes
_FORK = r"""
import os, sys, json, time, signal, traceback
import numpy, torch, torch.distributed, torch.distributed.tensor
n, path, timeout, out = int(sys.argv[1]), sys.argv[2], float(sys.argv[3]), \
    sys.argv[4]
src = open(path).read()
sys.stdout.flush()
sys.stderr.flush()
pids = []
for r in range(n):
    pid = os.fork()
    if pid == 0:
        os.environ["RANK"] = os.environ["LOCAL_RANK"] = str(r)
        torch.set_num_threads(1)
        for fd, ext in ((1, "out"), (2, "err")):
            os.dup2(os.open(os.path.join(out, f"{r}.{ext}"),
                            os.O_WRONLY | os.O_CREAT | os.O_TRUNC), fd)
        sys.argv = ["-c"] + sys.argv[5:]
        code = 0
        try:
            exec(compile(src, "<rank>", "exec"), {"__name__": "__main__"})
        except SystemExit as e:
            code = e.code if isinstance(e.code, int) else 1
        except BaseException:
            traceback.print_exc()
            code = 1
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(code)
    pids.append(pid)
codes, end = {}, time.time() + timeout
while len(codes) < n and time.time() < end:
    for pid in pids:
        if pid not in codes:
            got, status = os.waitpid(pid, os.WNOHANG)
            if got:
                codes[pid] = os.waitstatus_to_exitcode(status)
    time.sleep(0.02)
for pid in pids:
    if pid not in codes:
        os.kill(pid, signal.SIGKILL)
        os.waitpid(pid, 0)
        codes[pid] = "timeout"
print(json.dumps([codes[p] for p in pids]))
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(n, script, *, args=(), timeout=120, init=True):
    """Run ``script`` (after ``PRELUDE``, or after ``HEAD`` without
    ``init``; ``sys.argv[1:]`` is ``args``) on ``n`` gloo ranks; return
    each rank's ``emit``ted objects, by rank. Fails on a non-zero exit of
    any rank, or when the group outlives ``timeout`` seconds."""
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port()),
           "WORLD_SIZE": str(n), "OMP_NUM_THREADS": "1"}
    with tempfile.TemporaryDirectory() as out:
        path = os.path.join(out, "rank.py")
        with open(path, "w") as f:
            f.write((PRELUDE if init else HEAD) + script)
        r = subprocess.run(
            [sys.executable, "-c", _FORK, str(n), path, str(timeout), out,
             *map(str, args)], cwd=ROOT, env=env, capture_output=True,
            text=True, timeout=timeout + 60)
        assert r.returncode == 0, r.stdout + r.stderr
        codes = json.loads(r.stdout.splitlines()[-1])
        logs = []
        for rank in range(n):
            with open(os.path.join(out, f"{rank}.out")) as f:
                stdout = f.read()
            with open(os.path.join(out, f"{rank}.err")) as f:
                stderr = f.read()
            logs.append((stdout, stderr))
    for rank, (code, (stdout, stderr)) in enumerate(zip(codes, logs)):
        assert code == 0, (f"rank {rank} exited {code}:\n{stdout}\n"
                           f"{stderr[-4000:]}")
    return [[json.loads(line.split(" ", 1)[1]) for line in stdout.splitlines()
             if line.startswith("RANK_OUT ")] for stdout, _ in logs]
