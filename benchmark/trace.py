"""Reduce a ``torch.profiler`` window to what the per-layer readers need.

Device time is taken from the union of the device's operation intervals, so
operations that overlap are counted once; the idle share is the part of the
traced window that union leaves uncovered.  An idle gap is named by the
innermost host operation running at its middle.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Tuple

SPAN = "bench.traced"  # the host span that marks the traced window
TOP = 10


def _flag(event, what: str) -> bool:
    value = getattr(event, what, False)
    return bool(value() if callable(value) else value)


def _ns(event, what: str) -> int:
    """An event's start or duration in ns, across the profiler's two spellings."""
    if hasattr(event, f"{what}_ns"):
        return int(getattr(event, f"{what}_ns")())
    return int(getattr(event, f"{what}_us")() * 1000)


@dataclass
class Trace:
    """Device operations (name, start ns, end ns) and host operations inside the
    traced window, and the window's bounds."""

    start: int
    end: int
    device_ops: List[Tuple[str, int, int]]
    host_ops: List[Tuple[str, int, int]] = field(default_factory=list)

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        events = prof.profiler.kineto_results.events()
        device, host, span = [], [], None
        for e in events:
            start, dur = _ns(e, "start"), _ns(e, "duration")
            item = (e.name(), start, start + dur)
            if str(e.device_type()).endswith("CPU"):
                if e.name() == SPAN:
                    span = item
                host.append(item)
            elif not _flag(e, "is_user_annotation") and e.name() != SPAN:
                device.append(item)  # a kernel, copy or set; not a span mirrored on the card
        if span is None:
            raise RuntimeError(f"the trace holds no {SPAN!r} span")
        _, lo, hi = span
        return cls(lo, hi, [d for d in device if d[2] > lo and d[1] < hi],
                   [h for h in host if h[2] > lo and h[1] < hi and h[0] != SPAN])

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9

    def intervals(self) -> List[Tuple[int, int]]:
        """The union of the device operations' intervals, clipped to the window."""
        merged: List[List[int]] = []
        for _, s, e in sorted(self.device_ops, key=lambda d: d[1]):
            s, e = max(s, self.start), min(e, self.end)
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.intervals()) / 1e9

    def seconds(self, match: Callable[[str], bool]) -> float:
        """Summed device time of the operations whose name ``match`` accepts."""
        return sum(e - s for name, s, e in self.device_ops if match(name)) / 1e9

    def top_ops(self, n: int = TOP) -> List[list]:
        totals: Dict[str, int] = {}
        for name, s, e in self.device_ops:
            totals[name] = totals.get(name, 0) + e - s
        ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
        return [[_short(name), ns / 1e9] for name, ns in ranked]

    def idle_gaps(self, n: int = TOP) -> List[list]:
        """The ``n`` longest idle gaps, each named by the innermost host
        operation running at its middle."""
        bounds = [self.start, *(t for iv in self.intervals() for t in iv), self.end]
        gaps = sorted(((bounds[i + 1] - bounds[i], bounds[i]) for i in range(0, len(bounds), 2)
                       if bounds[i + 1] > bounds[i]), reverse=True)[:n]
        return [[self._host_at(start + length // 2), length / 1e9] for length, start in gaps]

    def _host_at(self, t: int) -> str:
        inside = [(s, name) for name, s, e in self.host_ops if s <= t < e]
        return _short(max(inside)[1]) if inside else "no host operation"


def _short(name: str, width: int = 96) -> str:
    return name if len(name) <= width else name[:width - 3] + "..."


def matcher(patterns: Iterable[str], unless: Iterable[str] = ()) -> Callable[[str], bool]:
    """A test of a kernel's name: it holds one of ``patterns`` and none of
    ``unless`` (case-insensitive)."""
    want, skip = [p.lower() for p in patterns], [p.lower() for p in unless]

    def match(name: str) -> bool:
        low = name.lower()
        return any(p in low for p in want) and not any(p in low for p in skip)

    return match


# the kernel-name groups the per-layer readers share, copied from the rules of
# the port's tools/profile_dit_step.py: the port's attention kernels
# (csrc/flash_attention.cu and its siblings), and the linear layers' kernels
# (the int8 row quantization and GEMMs, cuBLAS's bf16 GEMMs; not convolutions)
ATTENTION = matcher(("attention_kernel", "flash", "fmha", "pv8"))
LINEAR = matcher(("gemm", "gemv", "nvjet", "cutlass", "xmma", "splitk", "quantize_rows"),
                 unless=("conv", "fprop", "dgrad", "wgrad", "implicit"))
