"""Dynamic micro-batching for graph-model inference (PyTorch port of
tpuserve/engine/batcher.py).

Brings the reference's dead `dynamic_batching` / `instance_count` config
flags to life:

- `dynamic_batching: true` — concurrent `/infer` requests whose inputs
  differ only in the dynamic batch dim coalesce into ONE forward: the
  first arriving thread becomes the leader, waits up to
  `max_queue_delay_us` for followers, concatenates along dim 0, runs the
  backend once, and splits the outputs. On the card one forward of a
  bucketed batch costs little more than one of batch 1, and one
  host-to-device copy and one launch sequence serve every request.
- `instance_count: N` — at most N forwards in flight concurrently (a
  semaphore). With dynamic batching on, that bounds concurrent *leader*
  dispatches.

Requests whose shapes cannot coalesce (different non-batch dims, no
dynamic batch dim declared) fall through to direct execution.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from tpuserve_torch.utils.tensor import Tensor

InferFn = Callable[[List[Tensor]], List[Tensor]]


class _Pending:
    __slots__ = ("inputs", "batch", "event", "outputs", "error")

    def __init__(self, inputs: List[Tensor], batch: int):
        self.inputs = inputs
        self.batch = batch
        self.event = threading.Event()
        self.outputs: Optional[List[Tensor]] = None
        self.error: Optional[BaseException] = None


class _Window:
    """One leader's open batch: the followers that joined it."""

    __slots__ = ("sig", "rows", "members", "opened")

    def __init__(self, sig: Tuple, rows: int):
        self.sig = sig
        self.rows = rows
        self.members: List[_Pending] = []
        self.opened = time.monotonic()


class MicroBatcher:
    """Wraps an infer callable with leader/follower micro-batching.

    At most one batch window is open at a time, and each window owns the
    list of followers that joined it. A leader opens its window before it
    waits for an instance, so requests that arrive while a forward runs
    join the next one's batch; once it holds an instance it waits out the
    rest of `max_queue_delay_us` from the window's opening, closes the
    window and runs. (The JAX package's leader opens its window only after
    it holds an instance, so under load every request that arrives during
    a forward becomes a leader of its own and runs alone; its one shared
    queue is also reset by a second leader when instance_count > 1, and
    the followers queued there are never answered.)"""

    def __init__(self, infer_fn: InferFn, *, batch_axis_inputs: List[str],
                 max_batch: int = 0, max_queue_delay_us: int = 2000,
                 instance_count: int = 1, enabled: bool = True):
        self._infer = infer_fn
        self._batch_inputs = set(batch_axis_inputs)
        self._max_batch = max_batch  # 0 = unlimited
        self._delay_s = max_queue_delay_us / 1e6
        self._enabled = enabled and bool(batch_axis_inputs)
        self._lock = threading.Lock()
        self._window: Optional[_Window] = None
        self._instances = threading.Semaphore(max(1, instance_count))
        # telemetry (read by /stats)
        self.batches = 0
        self.batched_requests = 0

    # ------------------------------------------------------------------
    def _signature(self, inputs: List[Tensor]) -> Optional[Tuple]:
        """Coalescing key: names/dtypes/non-batch dims. None = unbatchable."""
        sig = []
        for t in sorted(inputs, key=lambda t: t.name):
            if t.name not in self._batch_inputs or len(t.shape) < 1:
                return None
            sig.append((t.name, t.dtype.value, tuple(t.shape[1:])))
        return tuple(sig)

    def infer(self, inputs: List[Tensor]) -> List[Tensor]:
        if not self._enabled:
            with self._instances:
                return self._infer(inputs)
        sig = self._signature(inputs)
        if sig is None:
            with self._instances:
                return self._infer(inputs)
        batch = inputs[0].shape[0] if inputs[0].shape else 1
        me = _Pending(inputs, batch)
        mine: Optional[_Window] = None
        with self._lock:
            # a follower joins the open window if the signatures match; a
            # leader opens one unless one is open that it could not join
            w = self._window
            follower = w is not None and w.sig == sig and (
                self._max_batch <= 0 or w.rows + batch <= self._max_batch)
            if follower:
                w.members.append(me)
                w.rows += batch
            elif w is None:
                mine = self._window = _Window(sig, batch)
        if follower:
            me.event.wait()
            if me.error is not None:
                raise me.error
            return me.outputs

        # leader path: take an instance, wait out the window, run the group
        with self._instances:
            group: List[_Pending] = []
            if mine is not None:
                left = mine.opened + self._delay_s - time.monotonic()
                if left > 0:
                    time.sleep(left)
                with self._lock:
                    group = mine.members
                    self._window = None
            try:
                outs = self._run_group(me, group)
            except BaseException as e:
                for p in group:
                    p.error = e
                    p.event.set()
                raise
            for p, po in zip(group, outs[1:]):
                p.outputs = po
                p.event.set()
            return outs[0]

    # ------------------------------------------------------------------
    def _run_group(self, leader: _Pending, group: List[_Pending]) -> List[List[Tensor]]:
        all_reqs = [leader] + group
        if not group:
            return [self._infer(leader.inputs)]
        # concatenate along the batch dim, preserving leader's input order
        by_name: Dict[str, List[np.ndarray]] = {}
        order = [t.name for t in leader.inputs]
        for req in all_reqs:
            named = {t.name: t for t in req.inputs}
            for n in order:
                by_name.setdefault(n, []).append(named[n].numpy())
        merged = []
        for t in leader.inputs:
            arr = np.concatenate(by_name[t.name], axis=0)
            merged.append(Tensor(name=t.name, dtype=t.dtype, shape=arr.shape, data=arr))
        outputs = self._infer(merged)
        with self._lock:
            self.batches += 1
            self.batched_requests += len(all_reqs)
        # split outputs back by each request's batch rows
        result: List[List[Tensor]] = []
        off = 0
        for req in all_reqs:
            per = []
            for o in outputs:
                arr = o.numpy()[off : off + req.batch]
                per.append(Tensor(name=o.name, dtype=o.dtype, shape=arr.shape, data=arr))
            result.append(per)
            off += req.batch
        return result
