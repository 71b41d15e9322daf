"""Controller/follower event bus (PyTorch port of tpuserve/parallel/dispatcher.py).

Rank 0, the controller, owns admission, slots, sampling and the REST/gRPC
front; before every step it publishes the step's host inputs (token ids,
positions, lengths, sampling settings) as one pickled event, and every
follower rank replays the same step on its own shards, in publish order.
All ranks then hold the same logits and the same sampler state, so they
draw the same tokens. Only O(batch) integers cross the bus; weights and KV
stay on each rank's card.

The bus is a gloo process group of its own (distributed.bus_group()) with
CPU tensors, whatever backend the steps' collectives use. An event is two
broadcasts from rank 0: a [1] int64 length, then the payload bytes. Publishes
may come from several controller threads (the scheduler, the manager's
load/unload workers, server teardown, the keep-alive), so a lock keeps each
two-phase broadcast whole.
"""

from __future__ import annotations

import pickle
import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

_PUBLISH_LOCK = threading.RLock()
_LAST_PUBLISH = [time.monotonic()]


def _bus():
    from tpuserve_torch.parallel.distributed import bus_group

    g = bus_group()
    if g is None:
        raise RuntimeError("the event bus needs the process group (distributed.initialize)")
    return g


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def is_controller() -> bool:
    return _rank() == 0


def broadcast_step(payload: np.ndarray) -> np.ndarray:
    """Controller (rank 0) -> all ranks: the controller's array, returned
    everywhere (followers pass an array of the same shape and dtype)."""
    import torch.distributed as dist

    t = torch.from_numpy(np.ascontiguousarray(payload).copy())
    dist.broadcast(t, src=0, group=_bus())
    return t.numpy()


def publish_event(obj) -> None:
    """Controller: broadcast one event object to every follower."""
    import torch.distributed as dist

    data = torch.frombuffer(bytearray(pickle.dumps(obj)), dtype=torch.uint8)
    with _PUBLISH_LOCK:
        dist.broadcast(torch.tensor([data.numel()], dtype=torch.int64), src=0, group=_bus())
        dist.broadcast(data, src=0, group=_bus())
        _LAST_PUBLISH[0] = time.monotonic()


def recv_event():
    """Follower: the next event (blocks in the broadcast, up to the group's
    timeout)."""
    import torch.distributed as dist

    n = torch.zeros((1,), dtype=torch.int64)
    dist.broadcast(n, src=0, group=_bus())
    data = torch.empty((int(n[0]),), dtype=torch.uint8)
    dist.broadcast(data, src=0, group=_bus())
    return pickle.loads(data.numpy().tobytes())


def exchange(obj) -> List:
    """Every rank's `obj`, in rank order, on every rank (two all_reduces on
    the bus: the longest pickle, then the zero-padded bytes). The controller
    calls it inside `controlled()` after publishing the event that makes the
    followers call it too."""
    import torch.distributed as dist

    world = dist.get_world_size()
    data = np.frombuffer(pickle.dumps(obj), np.uint8)
    n = torch.tensor([data.size], dtype=torch.int64)
    dist.all_reduce(n, op=dist.ReduceOp.MAX, group=_bus())
    buf = torch.zeros((world, int(n[0]) + 8), dtype=torch.uint8)
    buf[_rank(), :8] = torch.from_numpy(np.array([data.size], np.int64).view(np.uint8))
    buf[_rank(), 8:8 + data.size] = torch.from_numpy(data.copy())
    dist.all_reduce(buf, group=_bus())
    out = []
    for row in buf.numpy():
        size = int(row[:8].view(np.int64)[0])
        out.append(pickle.loads(row[8:8 + size].tobytes()))
    return out


def controlled():
    """The publish lock: hold it across an event and the exchange that
    follows it, so that no other publish comes between."""
    return _PUBLISH_LOCK


class _Heartbeat:
    """Publishes ("ping",) whenever nothing was published for `interval`
    seconds, so that idle followers never reach the bus's timeout."""

    def __init__(self, interval: float):
        self.interval = max(0.05, float(interval))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="tpuserve-torch-keepalive",
                                        daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval / 4):
            if time.monotonic() - _LAST_PUBLISH[0] >= self.interval:
                try:
                    publish_event(("ping",))
                except Exception:  # the group is gone: nothing left to keep alive
                    return

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)


def start_heartbeat(interval: float) -> _Heartbeat:
    _LAST_PUBLISH[0] = time.monotonic()
    return _Heartbeat(interval)


class MultiHostGenerator:
    """A minimal generation loop over a mesh of ranks: every rank builds it
    with the same arguments (seeded weights are equal by construction) and
    calls `generate()` in lockstep; the prompt is rank 0's, broadcast to the
    others, and every rank returns the same greedy tokens. The tests run
    the sharded model path through it without the engine's scheduler."""

    def __init__(self, p, *, n_slots: int = 4, max_len: int = 64, tp: int = 1, dp: int = 1,
                 sp: int = 1, seed: int = 0, quantized_kv: bool = False, device="cpu"):
        from tpuserve_torch.models import llama
        from tpuserve_torch.parallel.mesh import make_mesh
        from tpuserve_torch.parallel.sharding import (local_llama_params, set_active_mesh,
                                                      shard_llama_params)

        self.p = p
        self.n_slots = n_slots
        self.max_len = max_len
        self.device = torch.device(device)
        self.mesh = make_mesh(tp=tp, dp=dp, sp=sp)
        full = llama.init_params(p, dtype=torch.float32, device=self.device, seed=seed)
        self.params = shard_llama_params(full, self.mesh)
        self.cache = llama.KVCache.create(
            local_llama_params(p, self.mesh), n_slots // dp, max_len // sp,
            quantized=quantized_kv, dtype=torch.float32, flat=sp == 1, device=self.device)
        set_active_mesh(self.mesh)

    def generate(self, prompt_ids: Optional[Sequence[int]], max_new_tokens: int,
                 prompt_len_hint: int = 16) -> List[int]:
        """Greedy generation in slot 0; followers may pass None."""
        from tpuserve_torch.models import llama

        buf = np.zeros((prompt_len_hint + 1,), np.int64)
        if is_controller():
            if prompt_ids is None:
                raise ValueError("the controller must pass prompt_ids")
            buf[0] = len(prompt_ids)
            buf[1:1 + len(prompt_ids)] = prompt_ids
        buf = broadcast_step(buf)
        n = int(buf[0])
        bucket = 16
        while bucket < n:
            bucket *= 2
        tokens = torch.zeros((1, bucket), dtype=torch.long, device=self.device)
        tokens[0, :n] = torch.from_numpy(buf[1:1 + n])
        logits, _ = llama.prefill(self.params, self.p, tokens, self.cache, 0, n)
        out = [int(logits[0].argmax())]
        pos = n
        for _ in range(max_new_tokens - 1):
            t = torch.zeros((self.n_slots,), dtype=torch.long, device=self.device)
            positions = torch.full((self.n_slots,), -1, dtype=torch.int32, device=self.device)
            t[0], positions[0] = out[-1], pos
            logits, _ = llama.decode_step(self.params, self.p, t, self.cache, positions)
            out.append(int(logits[0].argmax()))
            pos += 1
        return out

    def follow(self, max_new_tokens: int, prompt_len_hint: int = 16) -> List[int]:
        return self.generate(None, max_new_tokens, prompt_len_hint)
