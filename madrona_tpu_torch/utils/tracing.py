"""Tracing and profiling hooks.

Port of ``madrona_tpu/utils/tracing.py``. The reference's three tracing
mechanisms map onto PyTorch as:

  * per-node device visibility -> :func:`node_scope`, a
    ``torch.profiler.record_function`` that the taskgraph wraps around
    every node (``graph/builder.py``), so a profile names each node as
    ``"<graph>.<node>"`` and the kernels it launched sit under it;
  * host events -> :class:`HostEventLog` (a monotonic-clock event list,
    dumped to JSON as the reference's per-thread trace files are);
  * launch-graph timing -> :func:`time_step` (mean and min ms a step,
    fenced by ``torch.cuda.synchronize()`` on a CUDA state).

:func:`profile_trace` is the counterpart of ``xprof_trace``: a
``torch.profiler`` run over the CPU and the card that writes a Chrome
trace. :func:`profile_events` and :func:`device_profile` read the
card's share of a profiled callable.

The node scopes are always on: with no profiler running they cost well
under 1 % of the Escape Room step at 4096 worlds on an H100 (PERF.md),
so the JAX module's ``MADRONA_TPU_TRACING`` switch has nothing to gate
here. ``MADRONA_TPU_TRACE_NAME`` names the file that
:meth:`HostEventLog.dump` writes by default.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Callable, List, Optional, Tuple

import torch

from .tree import tree_leaves


class HostEventLog:
    """The reference's HostEventLogging: (event, t_ns) pairs of one
    process, ``time.perf_counter_ns`` clock."""

    def __init__(self):
        self.events: List[Tuple[str, int]] = []

    def log(self, event: str):
        self.events.append((event, time.perf_counter_ns()))

    @contextlib.contextmanager
    def span(self, name: str):
        self.log(f"{name}:start")
        try:
            yield
        finally:
            self.log(f"{name}:end")

    def dump(self, path: Optional[str] = None) -> str:
        """Write the events as a JSON list of ``[event, t_ns]`` pairs to
        ``path`` (default: ``$MADRONA_TPU_TRACE_NAME.json``, else
        ``madrona_tpu_trace.json``); returns the path."""
        path = path or os.environ.get(
            "MADRONA_TPU_TRACE_NAME", "madrona_tpu_trace"
        ) + ".json"
        with open(path, "w") as f:
            json.dump(self.events, f)
        return path


GLOBAL_LOG = HostEventLog()


def node_scope(name: str):
    """The annotation around every taskgraph node: a profile shows the
    node's host span and the kernels launched inside it under ``name``,
    where the reference's device event ring logged node start and
    finish."""
    return torch.profiler.record_function(name)


def _fence(tree):
    """Wait for the card's queue where ``tree`` lives on a CUDA device."""
    leaves = tree_leaves(tree)
    if leaves and leaves[0][1].device.type == "cuda":
        torch.cuda.synchronize(leaves[0][1].device)


def time_step(step_fn: Callable, state, inputs, iters: int = 20,
              warmup: int = 2):
    """Launch-graph-style timing of ``step_fn(state, inputs)``: mean and
    min ms a call after ``warmup`` calls, each call fenced by
    ``torch.cuda.synchronize()`` when ``state`` lives on the card.
    Returns {"mean_ms", "min_ms", "iters"}."""
    for _ in range(warmup):
        step_fn(state, inputs)
    _fence(state)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = step_fn(state, inputs)
        _fence(out)
        times.append(time.perf_counter() - t0)
    return {
        "mean_ms": 1e3 * sum(times) / len(times),
        "min_ms": 1e3 * min(times),
        "iters": iters,
    }


def _activities(host: bool = True, device: Optional[bool] = None):
    from torch.profiler import ProfilerActivity

    if device is None:
        device = torch.cuda.is_available()
    return (([ProfilerActivity.CPU] if host else [])
            + ([ProfilerActivity.CUDA] if device else []))


@contextlib.contextmanager
def profile_trace(logdir: str, host: bool = True,
                  device: Optional[bool] = None):
    """``torch.profiler.profile`` over the CPU (``host``) and the card
    (``device``; default: where CUDA is available). Yields the profiler;
    on exit writes its Chrome trace to ``<logdir>/trace.json`` (view it
    in chrome://tracing or Perfetto) and sets ``prof.trace_path``."""
    from torch.profiler import profile

    os.makedirs(logdir, exist_ok=True)
    with profile(activities=_activities(host, device)) as prof:
        yield prof
    prof.trace_path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(prof.trace_path)


def profile_events(run: Callable, calls: int = 5, host: bool = True):
    """``key_averages()`` of ``calls`` calls of ``run()`` under
    torch.profiler: the card's events (kernels, copies, fills) and, with
    ``host``, the host's operators and node scopes (``host=False``
    records the card alone: much less to collect on a long call)."""
    from torch.profiler import profile

    with profile(activities=_activities(host, True)) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    return prof.key_averages()


def device_profile(run: Callable, calls: int = 5, host: bool = True):
    """(device events a call, device ms a call) of ``run()`` over
    ``calls`` calls; (None, None) where the profiler recorded no device
    time."""
    events = [e for e in profile_events(run, calls, host)
              if e.device_type.name == "CUDA"]
    busy_us = sum(e.self_device_time_total for e in events)
    if not busy_us:
        return None, None
    return sum(e.count for e in events) / calls, busy_us / 1e3 / calls
