"""Per-model inference statistics.

Reference counterpart: `ModelStats` (model.h:168-175) updated around each
Infer (model.cpp:572-610) — inference count, total/last ns, load time, memory
estimate. The reference mutates these without a lock while allowing
concurrent inference (benign race, SURVEY.md §2c.9); here updates are locked.

TPU extensions (north star telemetry): latency percentiles from a bounded
reservoir, token counters for LLM backends, and tokens/s over a sliding
window.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional


class ModelStats:
    _RESERVOIR = 2048  # most-recent latencies kept for percentile estimates

    def __init__(self):
        self._lock = threading.Lock()
        self.inference_count = 0
        self.error_count = 0
        self.total_inference_ns = 0
        self.last_inference_ns = 0
        self.load_time_ns = 0
        self.memory_usage_bytes = 0
        self.tokens_generated = 0
        self.tokens_prefilled = 0
        self._latencies_ns = deque(maxlen=self._RESERVOIR)
        self._token_events = deque(maxlen=8192)  # (t, n) for tokens/s window

    # ------------------------------------------------------------------
    def record_inference(self, duration_ns: int) -> None:
        with self._lock:
            self.inference_count += 1
            self.total_inference_ns += duration_ns
            self.last_inference_ns = duration_ns
            self._latencies_ns.append(duration_ns)

    def record_error(self) -> None:
        with self._lock:
            self.error_count += 1

    def record_tokens(self, generated: int = 0, prefilled: int = 0) -> None:
        now = time.monotonic()
        with self._lock:
            self.tokens_generated += generated
            self.tokens_prefilled += prefilled
            if generated:
                self._token_events.append((now, generated))

    def set_load_time(self, ns: int) -> None:
        with self._lock:
            self.load_time_ns = ns

    def set_memory_usage(self, nbytes: int) -> None:
        with self._lock:
            self.memory_usage_bytes = nbytes

    # ------------------------------------------------------------------
    def _percentile_ns(self, q: float) -> int:
        if not self._latencies_ns:
            return 0
        xs = sorted(self._latencies_ns)
        idx = min(int(q * len(xs)), len(xs) - 1)
        return xs[idx]

    def tokens_per_second(self, window_s: float = 10.0) -> float:
        now = time.monotonic()
        with self._lock:
            total = sum(n for t, n in self._token_events if now - t <= window_s)
        return total / window_s

    def snapshot(self) -> Dict:
        with self._lock:
            count = self.inference_count
            avg_ns = self.total_inference_ns // count if count else 0
            return {
                "inference_count": count,
                "error_count": self.error_count,
                "total_inference_ns": self.total_inference_ns,
                "last_inference_ns": self.last_inference_ns,
                "avg_inference_ns": avg_ns,
                "p50_inference_ns": self._percentile_ns(0.50),
                "p99_inference_ns": self._percentile_ns(0.99),
                "load_time_ns": self.load_time_ns,
                "memory_usage_bytes": self.memory_usage_bytes,
                "tokens_generated": self.tokens_generated,
                "tokens_prefilled": self.tokens_prefilled,
            }
