"""Stopwatch + device profiling hooks.

JAX rebuild of the reference Stopwatch/ProgressBar instrumentation
(reference: src/stopwatch.hpp:3-12, laps used in src/nni_engine.cpp:230-257
and src/gp_instance.cpp:303-309) plus jax.profiler trace capture for device
timelines (SURVEY §5.1's "jax profiler traces + per-phase timers").
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional


class Stopwatch:
    """Lap/total timer (reference Stopwatch semantics)."""

    def __init__(self, start: bool = True):
        self._start: Optional[float] = None
        self._laps: List[float] = []
        self._last: Optional[float] = None
        if start:
            self.start()

    def start(self):
        self._start = self._last = time.perf_counter()

    def lap(self) -> float:
        now = time.perf_counter()
        assert self._last is not None, "Stopwatch not started"
        lap = now - self._last
        self._laps.append(lap)
        self._last = now
        return lap

    def stop(self) -> float:
        return self.lap()

    def total(self) -> float:
        assert self._start is not None
        return time.perf_counter() - self._start

    @property
    def laps(self) -> List[float]:
        return list(self._laps)


class PhaseTimer:
    """Named-phase accumulator for engine loops (the NNI engine's per-stage
    lap report, reference src/nni_engine.cpp:230-257)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = ["# Timing Report"]
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(
                f"{name}: {total:.3f}s over {self.counts[name]} calls"
            )
        return "\n".join(lines)


class ProgressBar:
    """Terminal progress bar (reference src/ProgressBar.hpp:9-66, used by
    GenericSBNInstance's bulk loops): `bar = ProgressBar(total)`, `next()`
    or `+= 1` per tick, `display()` to redraw in place, `done()` to finish
    the line."""

    def __init__(self, total: int, width: int = 70,
                 complete: str = "=", incomplete: str = " "):
        self.total = max(int(total), 1)
        self.width = width
        self.complete_char = complete
        self.incomplete_char = incomplete
        self.ticks = 0
        self._start = time.perf_counter()

    def __iadd__(self, n: int) -> "ProgressBar":
        self.ticks += n
        return self

    def next(self) -> int:
        self.ticks += 1
        return self.ticks

    def seconds_elapsed(self) -> float:
        return time.perf_counter() - self._start

    def display(self, show_hours: bool = False, stream=None) -> None:
        import sys

        stream = stream or sys.stdout
        progress = self.ticks / self.total
        pos = int(self.width * progress)
        bar = "".join(
            self.complete_char if i < pos else
            (">" if i == pos else self.incomplete_char)
            for i in range(self.width)
        )
        secs = self.seconds_elapsed()
        tail = (f"s {secs / 60.0:.2f}m {secs / 3600.0:.4f}h"
                if show_hours else "s")
        stream.write(f"[{bar}] {int(progress * 100)}% {secs:.1f}{tail}\r")
        stream.flush()

    def done(self, stream=None) -> None:
        import sys

        stream = stream or sys.stdout
        self.display(stream=stream)
        stream.write("\n")
        stream.flush()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a jax profiler trace (viewable in TensorBoard/Perfetto)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def block_until_ready(tree):
    """Barrier helper for timing device work accurately."""
    import jax

    return jax.block_until_ready(tree)


def time_branch_sweep(engine, trees, params, iters: int, reps: int = 5):
    """Compile, then time, `iters` LL+gradient evaluations of a tree batch
    run as one jitted lax.scan over scaled branch lengths — the way a VBPI
    inner loop or a branch-length sweep embeds `branch_eval_fn`.  Each rep
    scales the branch lengths anew, so no rep reuses a result.  Returns
    (compile seconds, [seconds per rep], the compiled sweep)."""
    import jax
    import jax.numpy as jnp

    base_bl = engine.branch_length_matrix(trees, engine.encode(trees))
    eval_fn = engine.branch_eval_fn(trees, params)

    def sweep(bl):
        def body(carry, k):
            ll, grads = eval_fn(bl * (1.0 + 0.001 * k))
            return carry + ll.sum() + grads.sum(), None

        total, _ = jax.lax.scan(body, jnp.zeros((), bl.dtype),
                                jnp.arange(iters, dtype=bl.dtype))
        return total

    t0 = time.perf_counter()
    compiled = jax.jit(sweep).lower(base_bl).compile()
    compiled(base_bl).block_until_ready()
    compile_s = time.perf_counter() - t0
    times = []
    for r in range(reps):
        bl = base_bl * (1.0 + 1e-4 * (r + 1))
        bl.block_until_ready()
        t0 = time.perf_counter()
        compiled(bl).block_until_ready()
        times.append(time.perf_counter() - t0)
    return compile_s, times, compiled
