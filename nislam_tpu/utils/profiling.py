"""Tracing & profiling utilities (SURVEY §5: the reference has only ad-hoc
``std::chrono`` per-frame prints, /root/reference/main.cpp:61-65).

- :class:`StageTimer` — named host-side wall-clock accumulators with the
  per-frame ms print as a formatting option (CLI parity with the
  reference's stdout),
- :func:`trace` — context manager around ``jax.profiler`` emitting a
  TensorBoard-loadable trace directory,
- :func:`device_fence` — block until a pytree's device work finished.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator


def device_fence(x) -> None:
    """Block until every array of the pytree ``x`` is computed."""
    import jax

    jax.block_until_ready(x)


class StageTimer:
    """Accumulate wall-clock per named stage; print summaries.

    ``clock`` returns seconds (default ``time.perf_counter``)."""

    def __init__(self, clock: Callable[[], float] = time.perf_counter) -> None:
        self.clock = clock
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, *, fence=None) -> Iterator[None]:
        t0 = self.clock()
        yield
        if fence is not None:
            device_fence(fence)
        dt = self.clock() - t0
        self.total[name] += dt
        self.count[name] += 1

    def mean_ms(self, name: str) -> float:
        return 1e3 * self.total[name] / max(self.count[name], 1)

    def summary(self) -> str:
        lines = []
        for name in sorted(self.total, key=lambda n: -self.total[n]):
            lines.append(
                f"{name:24s} {self.total[name]:8.3f}s total "
                f"{self.mean_ms(name):9.3f}ms/call x{self.count[name]}"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """``jax.profiler`` trace context (view with TensorBoard)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
