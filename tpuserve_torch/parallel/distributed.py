"""Process-group initialization (PyTorch port of tpuserve/parallel/distributed.py).

Every rank of a sharded model is a process. Ranks join one torch.distributed
process group, through a TCPStore at process 0's address, under the JAX
package's three variables:

  TPUSERVE_COORDINATOR   host:port of process 0
  TPUSERVE_NUM_PROCESSES, TPUSERVE_PROCESS_ID

`initialize()` is a no-op when none is set. On one host the engine starts its
own follower ranks instead (`launch_local_ranks`), on 127.0.0.1 and a free
port, each marked TPUSERVE_ENGINE_RANK=1 (`joined_by_variables` tells the two
forms apart). The backend is NCCL where every rank has its own card, gloo
where ranks share one (or run on the CPU).
Every group is made with a timeout (TPUSERVE_DIST_TIMEOUT seconds, 600 by
default), so a rank that dies or stalls ends in an error on the others, not
a hang. Beside the default group, a gloo group carries the controller's
event bus (parallel/dispatcher.py); while process 0 publishes nothing for a
quarter of the timeout, it publishes a keep-alive event.
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Optional

import torch

from tpuserve_torch.utils.errors import BackendError

_REPO_ROOT = Path(__file__).resolve().parent.parent.parent
_STATE = {"bus": None, "backend": None, "heartbeat": None}


def timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=float(os.environ.get("TPUSERVE_DIST_TIMEOUT", "600")))


def choose_backend(device_type: str, world: int) -> str:
    """NCCL when each of the `world` ranks of this host has a card of its
    own; gloo when they share one, or run on the CPU."""
    if device_type == "cuda" and torch.cuda.is_available() \
            and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, device_type: str = "cuda",
               await_followers=None, store=None) -> bool:
    """Join the process group; False (and nothing done) when no coordinator
    and no process count is configured. `await_followers(store)` runs on
    process 0 before the group forms (the engine checks there that the
    ranks it started are alive). `store`: process 0's TCPStore, already
    listening at the coordinator's address (launch_local_ranks)."""
    import torch.distributed as dist

    addr = coordinator_address or os.environ.get("TPUSERVE_COORDINATOR")
    if num_processes is None and os.environ.get("TPUSERVE_NUM_PROCESSES"):
        num_processes = int(os.environ["TPUSERVE_NUM_PROCESSES"])
    if process_id is None and os.environ.get("TPUSERVE_PROCESS_ID"):
        process_id = int(os.environ["TPUSERVE_PROCESS_ID"])
    if addr is None and num_processes is None:
        return False
    if dist.is_initialized():
        return True
    if addr is None or num_processes is None or process_id is None:
        raise BackendError("TPUSERVE_COORDINATOR, TPUSERVE_NUM_PROCESSES and "
                           "TPUSERVE_PROCESS_ID must all be set")
    host, port = addr.rsplit(":", 1)
    if store is None:
        store = dist.TCPStore(host, int(port), num_processes, is_master=process_id == 0,
                              timeout=timeout(), wait_for_workers=False)
    if process_id == 0:
        if await_followers is not None:
            await_followers(store)
    else:
        store.add("tpuserve/joined", 1)
    backend = choose_backend(device_type, num_processes)
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes, timeout=timeout())
    _STATE["backend"] = backend
    _STATE["bus"] = dist.new_group(backend="gloo", timeout=timeout())
    if process_id == 0 and num_processes > 1:
        from tpuserve_torch.parallel.dispatcher import start_heartbeat

        _STATE["heartbeat"] = start_heartbeat(timeout().total_seconds() / 4)
    return True


def bus_group():
    return _STATE["bus"]


def backend() -> Optional[str]:
    return _STATE["backend"]


def is_initialized() -> bool:
    import torch.distributed as dist

    return dist.is_initialized()


def is_multi_host() -> bool:
    """More than one process in the group (the JAX name: ranks may share a
    host here)."""
    return process_info()["process_count"] > 1


def process_info() -> dict:
    import torch.distributed as dist

    up = dist.is_initialized()
    return {"process_index": dist.get_rank() if up else 0,
            "process_count": dist.get_world_size() if up else 1,
            "local_devices": torch.cuda.device_count() if torch.cuda.is_available() else 0,
            "backend": _STATE["backend"]}


def shutdown() -> None:
    """Leave the process group (stops the keep-alive first)."""
    import torch.distributed as dist

    hb = _STATE["heartbeat"]
    if hb is not None:
        hb.stop()
    _STATE.update(bus=None, backend=None, heartbeat=None)
    if dist.is_initialized():
        dist.destroy_process_group()


def joined_by_variables() -> bool:
    """Whether this process's ranks are the CLI's multi-process form (joined
    by the TPUSERVE_* variables: the JAX package's multi-host), not ranks
    an engine started on its own host (`launch_local_ranks` marks those
    TPUSERVE_ENGINE_RANK=1; their controller forms the group only in
    start())."""
    if os.environ.get("TPUSERVE_ENGINE_RANK") == "1":
        return False
    return is_initialized() or bool(os.environ.get("TPUSERVE_NUM_PROCESSES"))


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_local_ranks(world: int, device_type: str,
                       log_dir: Optional[str] = None) -> List[subprocess.Popen]:
    """Start ranks 1..world-1 on this host as `python -m
    tpuserve_torch.server.follower --once` and join them as rank 0. Their
    output goes to `log_dir`/follower-<rank>.log where given (or
    TPUSERVE_FOLLOWER_LOG_DIR), else to this process's stderr. Raises
    BackendError if one of them exits before the group forms.

    Rank 0's store listens on a port the system picks before any follower
    is told of it: a port found free, closed and bound only later could be
    taken in between by another process starting ranks on this host."""
    import torch.distributed as dist

    store = dist.TCPStore("127.0.0.1", 0, world, is_master=True, timeout=timeout(),
                          wait_for_workers=False)
    port = store.port
    log_dir = log_dir or os.environ.get("TPUSERVE_FOLLOWER_LOG_DIR")
    procs: List[subprocess.Popen] = []
    for r in range(1, world):
        env = dict(os.environ, TPUSERVE_COORDINATOR=f"127.0.0.1:{port}",
                   TPUSERVE_NUM_PROCESSES=str(world), TPUSERVE_PROCESS_ID=str(r),
                   TPUSERVE_PLATFORM=device_type, TPUSERVE_ENGINE_RANK="1")
        env["PYTHONPATH"] = os.pathsep.join(
            [str(_REPO_ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            out = open(os.path.join(log_dir, f"follower-{r}.log"), "ab")
        else:
            out = 2  # this process's stderr: never its standard output
        try:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "tpuserve_torch.server.follower", "--once"],
                env=env, stdout=out, stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL))
        finally:
            if log_dir:
                out.close()

    def await_followers(store):
        deadline = time.monotonic() + timeout().total_seconds()
        while store.add("tpuserve/joined", 0) < world - 1:
            for r, proc in enumerate(procs, start=1):
                if proc.poll() is not None:
                    raise BackendError(f"follower rank {r} exited with code "
                                       f"{proc.returncode} before joining the process group")
            if time.monotonic() > deadline:
                raise BackendError("follower ranks did not join the process group in time")
            time.sleep(0.05)

    try:
        initialize(f"127.0.0.1:{port}", world, 0, device_type=device_type,
                   await_followers=await_followers, store=store)
    except BaseException:
        stop_local_ranks(procs, grace=0.0)
        raise
    return procs


def stop_local_ranks(procs: List[subprocess.Popen], grace: float = 60.0) -> List[int]:
    """Wait up to `grace` seconds for started ranks to exit, then kill the
    rest; returns their exit codes."""
    deadline = time.monotonic() + grace
    codes = []
    for proc in procs:
        try:
            proc.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        codes.append(proc.returncode)
    return codes
