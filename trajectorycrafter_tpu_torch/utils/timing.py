"""The port's tracer: wall-clock seconds per pipeline stage, and spans.

``StageTimer``: a stage's time ends in ``torch.cuda.synchronize()`` when the
device is a card, since PyTorch returns before the card finishes; on the CPU
the host clock alone is the stage's time.  Each stage is also the span
``stage.<name>`` on its device's clock: the time in the stage outside the
spans it holds (``tools/profile_dit_step.py --clip`` prints it beside the
stage's seconds and the device's busy time in it).

``span(name, where)``: a context manager opened at a layer's boundary (the
sampler step, the DiT's modules, every linear layer, the attention
dispatch), ``where`` a tensor of the layer's work or its device.  It traces
exactly while a ``torch.profiler`` is recording; otherwise it costs one
boolean test and records nothing.  While tracing, a span

- opens a ``torch.profiler.record_function(name)`` range, so that its host
  side is in the profiler's trace on the device's clock;
- marks its entry and its exit on the clock of the device its outermost
  open span's ``where`` lies on: a timing ``torch.cuda.Event`` on the
  current stream for a card, the host clock for the CPU (where operations
  are synchronous).  The time between two consecutive marks goes to the
  innermost span open between them: the self times of all spans partition
  the outermost span's time on that device, launch bubbles and idle
  stretches included (a span of host work on a card reads its wall time);
- counts its calls.

``span_totals()`` returns, per span name, the self seconds and calls
accumulated while tracing was on.  Events are resolved without a
synchronize: the completed ones at each outermost span's exit (and whenever
many are pending), the rest when ``span_totals`` is read, which waits for
them.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from typing import Dict, NamedTuple

import torch
import torch.autograd.profiler as _profiler
from torch.autograd.profiler import record_function

# pending boundaries beyond which the completed ones are resolved at once
_RESOLVE_AT = 2048


class SpanTotal(NamedTuple):
    self_s: float  # device seconds while this span was the innermost open one
    calls: int


class _Tracer:
    """The open spans and the boundaries not resolved yet (one per process)."""

    def __init__(self):
        self.stack = []  # (name, its record_function range) of the open spans
        self.cuda = False  # whether the outermost open span is timed by CUDA events
        self.marks = deque()  # (event, the span owning the time up to it, or None)
        self.pool = []  # resolved events, recorded again
        self.last_ns = 0  # host clock at the last boundary (CPU)
        self.self_s: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}

    def boundary(self, owner) -> None:
        """Close the interval since the last boundary, owned by ``owner``."""
        if self.cuda:
            event = self.pool.pop() if self.pool else torch.cuda.Event(enable_timing=True)
            event.record()
            self.marks.append((event, owner))
            if len(self.marks) > _RESOLVE_AT:
                self.resolve(wait=False)
            return
        now = time.perf_counter_ns()
        if owner is not None:
            self.self_s[owner] = self.self_s.get(owner, 0.0) + (now - self.last_ns) * 1e-9
        self.last_ns = now

    def resolve(self, wait: bool) -> None:
        """Fold the completed intervals (all of them with ``wait``) into the
        totals; the last boundary stays as the start of the next interval."""
        marks = self.marks
        while len(marks) > 1:
            event, owner = marks[1]
            if wait:
                event.synchronize()
            elif not event.query():
                return
            if owner is not None:
                seconds = marks[0][0].elapsed_time(event) * 1e-3
                self.self_s[owner] = self.self_s.get(owner, 0.0) + seconds
            self.pool.append(marks.popleft()[0])

    def open(self, name: str, where) -> None:
        rf = record_function(name)
        rf.__enter__()
        if self.stack:
            self.boundary(self.stack[-1][0])
        else:
            self.cuda = _on_card(where)
            self.boundary(None)
        self.stack.append((name, rf))
        self.calls[name] = self.calls.get(name, 0) + 1

    def close(self) -> None:
        name, rf = self.stack[-1]
        self.boundary(name)
        self.stack.pop()
        rf.__exit__(None, None, None)
        if not self.stack and self.cuda:
            self.resolve(wait=False)


_TRACER = _Tracer()


def _on_card(where) -> bool:
    """Whether an outermost span's ``where`` (a tensor or a device) lies on
    a card."""
    device = where if isinstance(where, torch.device) else where.device
    return device.type == "cuda"


class span:
    """``with span(name, where):`` the layer's work on ``where`` (a tensor or
    a device); traced only under a profiler."""

    __slots__ = ("name", "where", "on")

    def __init__(self, name: str, where):
        self.name = name
        self.where = where

    def __enter__(self):
        self.on = _profiler._is_profiler_enabled
        if self.on:
            _TRACER.open(self.name, self.where)
        return self

    def __exit__(self, *exc):
        if self.on:
            _TRACER.close()
        return False


def span_totals() -> Dict[str, SpanTotal]:
    """Self seconds and calls per span name since the last ``reset_spans``,
    every pending event resolved (this waits for the device)."""
    _TRACER.resolve(wait=True)
    return {name: SpanTotal(_TRACER.self_s.get(name, 0.0), calls)
            for name, calls in _TRACER.calls.items()}


def reset_spans() -> None:
    """Forget the totals (spans open now keep being timed)."""
    _TRACER.resolve(wait=True)
    _TRACER.self_s.clear()
    _TRACER.calls.clear()


class StageTimer:
    """Accumulates seconds per stage name in ``seconds``."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.seconds: Dict[str, float] = {}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def __call__(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            with span(f"stage.{name}", self.device):
                yield
        finally:
            self._sync()
            self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0
