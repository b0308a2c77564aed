"""Tracing / profiling helpers (the reference has none — SURVEY.md par.5
notes only commented-out printf relics; this is the framework's
observability upgrade).

* :func:`trace` — context manager around ``jax.profiler`` producing a
  TensorBoard-loadable trace of the compiled step.
* :func:`step_timer` — robust wall-clock timing of a jitted callable.
* :func:`cost_summary` — XLA cost analysis of a compiled function:
  FLOPs, transcendentals, bytes accessed — the roofline inputs.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict

import jax


@contextlib.contextmanager
def trace(logdir: str):
    """``with trace("/tmp/tb"): fn(...)`` then ``tensorboard --logdir``."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def step_timer(fn: Callable, *args, warmup: int = 1,
               repeats: int = 5) -> Dict[str, float]:
    """Compile (if needed), then time ``fn(*args)`` with device sync.
    Returns {best, mean, compile} seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    jax.block_until_ready(out)
    compile_s = time.perf_counter() - t0
    for _ in range(max(0, warmup - 1)):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return {"best": min(times), "mean": sum(times) / len(times),
            "compile": compile_s}


def cost_summary(fn: Callable, *args) -> Dict[str, Any]:
    """XLA cost analysis of the lowered+compiled fn: flops,
    transcendentals, bytes accessed (roofline numerator/denominators)."""
    compiled = jax.jit(fn).lower(*args).compile()
    cost = compiled.cost_analysis()
    keys = ("flops", "transcendentals", "bytes accessed")
    return {k: cost.get(k, float("nan")) for k in keys} | {
        "raw": {k: v for k, v in cost.items() if isinstance(v, float)}}
