"""Wall-clock timing helpers (``repro.utils.timing``'s counterparts)."""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch

from repro_torch.utils.trees import tree_leaves


@dataclass
class Timer:
    """Accumulating named timer: ``with timer("phase"): ...``."""

    totals: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def mean(self, name: str) -> float:
        return self.totals[name] / max(self.counts.get(name, 1), 1)

    def summary(self) -> str:
        total = sum(self.totals.values()) or 1.0
        lines = []
        for k in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(
                f"{k:>16s}: {self.totals[k]:10.4f}s "
                f"({100.0 * self.totals[k] / total:5.1f}%)  n={self.counts[k]}"
            )
        return "\n".join(lines)


def synchronize(result) -> None:
    """Wait for every CUDA device that holds a tensor of ``result`` (a
    tensor or a dict/list/tuple tree of them)."""
    for dev in {t.device for t in tree_leaves(result)
                if isinstance(t, torch.Tensor) and t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


def timed(fn, *args, n: int = 5, warmup: int = 1, **kwargs):
    """Return (result, seconds_per_call), each call waited for on the
    devices its result lies on."""
    result = None
    for _ in range(warmup):
        result = fn(*args, **kwargs)
        synchronize(result)
    t0 = time.perf_counter()
    for _ in range(n):
        result = fn(*args, **kwargs)
        synchronize(result)
    return result, (time.perf_counter() - t0) / n
