"""Timers of a call on the CUDA card, shared by ``chip_smoke.py`` and the
profiling tools.

- :func:`runs_ms`: ms per call over runs of calls enqueued back to back,
  CUDA events around each run; it counts the host wherever the host's
  enqueue per call is longer than the call's device time.
- :func:`graph_ms`: device ms per call, CUDA events around the replay of a
  CUDA graph of the calls, so the host's enqueue is not counted.
- :func:`enqueue_ms`: the host's ms per call to enqueue the call's work.
"""

from __future__ import annotations

import statistics
import time

import torch

CALLS = 10
REPS = 10


def _events_ms(run, calls: int, reps: int) -> float:
    """Median over ``reps`` of ``run()``'s time between two CUDA events, per call."""
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def _warm(fn) -> None:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()


def runs_ms(fn, launches: int = CALLS, reps: int = REPS) -> float:
    """Per-call time of ``fn`` after warm-up: the median over ``reps`` runs of
    ``launches`` calls enqueued back to back, CUDA events around each run.  A
    run of many calls keeps the card busy while the host enqueues the next,
    so the host's dispatch per call is not counted as long as it is shorter
    than the call's device time.  ``launches=1`` times one call as a caller
    waits for it."""
    _warm(fn)

    def run():
        for _ in range(launches):
            fn()

    return _events_ms(run, launches, reps)


def graph_ms(fn, calls: int = CALLS, reps: int = REPS) -> float:
    """Device ms per call: the median over ``reps`` replays of a CUDA graph
    of ``calls`` calls of ``fn``, CUDA events around each replay."""
    _warm(fn)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ms = _events_ms(graph.replay, calls, reps)
    del graph
    return ms


def enqueue_ms(fn, calls: int = 20) -> float:
    """Host ms per call to enqueue ``fn``'s work (no synchronisation inside
    the run; the card runs behind)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = 1000.0 * (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    return ms
