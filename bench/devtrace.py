"""The traced run's profiled slice: ``torch.profiler`` over whole engine
steps in the middle of the window, read into device operations, host
operations and the slice's length.

``start()`` and ``stop()`` each synchronise the device first, so the
slice holds the device work of exactly the steps run between them; its
length is the host clock between the two. Every time in the readings is
in seconds on the profiler's clock, which device and host operations
share.
"""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, field
from typing import List, Tuple

import torch

#: device operations that move or set memory rather than run a kernel
_COPIES = ("Memcpy", "Memset")
#: characters of an operation's name kept in the breakdown
NAME_CHARS = 120
#: the harness's own host ranges (``record_function``), which the
#: profiler also shows as device-side ranges
ANNOTATIONS = ("engine.step",)
#: host events of the profiler itself, never the name of an idle gap
PROFILER_OWN = ("Activity Buffer Request",)


@dataclass
class Reading:
    window_s: float
    #: (name, start, duration) of every device operation
    device: List[Tuple[str, float, float]] = field(default_factory=list)
    #: (name, start, end) of every host operation
    host: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def kernels(self) -> List[Tuple[str, float, float]]:
        return [e for e in self.device if not e[0].startswith(_COPIES)]

    def busy_s(self) -> float:
        """Seconds in which some device operation ran (their union)."""
        busy, end = 0.0, None
        for _, s, d in sorted(self.device, key=lambda e: e[1]):
            e = s + d
            if end is None or s >= end:
                busy += d
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy

    def kernel_seconds(self, names) -> float:
        """Device time of the kernels whose name holds one of ``names``."""
        return sum(d for n, _, d in self.kernels
                   if any(k in n for k in names))

    def top_ops(self, k: int = 10) -> List[list]:
        tot: dict = {}
        for n, _, d in self.device:
            tot[n] = tot.get(n, 0.0) + d
        return [[n[:NAME_CHARS], s] for n, s in
                sorted(tot.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """The ``k`` longest stretches with no device operation between
        the slice's first and last one, each named by the innermost host
        operation running at its middle."""
        ev = sorted(self.device, key=lambda e: e[1])
        gaps, end = [], None
        for _, s, d in ev:
            if end is not None and s > end:
                gaps.append((s - end, end, s))
            end = s + d if end is None else max(end, s + d)
        gaps.sort(key=lambda g: -g[0])
        out = []
        for length, a, b in gaps[:k]:
            mid = 0.5 * (a + b)
            inner = None
            for n, hs, he in self.host:
                if n in PROFILER_OWN:
                    continue
                if hs <= mid <= he and (inner is None
                                        or he - hs < inner[1]):
                    inner = (n, he - hs)
            out.append([(inner[0] if inner else "host: between steps")
                        [:NAME_CHARS], length])
        return out


class Slice:
    """One profiled stretch of the window. ``stop()`` only stops the
    profiler; the events are read by :meth:`read` once the window has
    closed, so reading them costs the window nothing."""

    def __init__(self):
        self._prof = None
        self._t0 = 0.0
        self.window_s = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            self._prof.__exit__(None, None, None)

    def read(self) -> "Reading":
        return read(self._prof, self.window_s)


def _on_device(e, cuda) -> bool:
    """A device operation: a kernel, copy or set on the card, not the
    device-side range of a host annotation."""
    annotation = getattr(e, "is_user_annotation", lambda: False)()
    return (e.device_type() == cuda and not annotation
            and e.name() not in ANNOTATIONS)


def read(prof, window_s: float) -> Reading:
    """The slice's operations from a finished ``torch.profiler`` run, in
    seconds from its first event."""
    from torch.autograd import DeviceType
    cuda = DeviceType.CUDA
    raw = [(_on_device(e, cuda), e.name(), e.start_ns(), e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() != cuda or _on_device(e, cuda)]
    base = min((r[2] for r in raw), default=0)
    r = Reading(window_s=window_s)
    for dev, name, s, d in raw:
        s = (s - base) * 1e-9
        if dev:
            r.device.append((name, s, d * 1e-9))
        else:
            r.host.append((name, s, s + d * 1e-9))
    return r


def warm() -> None:
    """Start and stop the profiler once in set-up, so the window's slice
    does not pay the profiler's first start."""
    s = Slice()
    s.start()
    torch.zeros(1, device="cuda" if torch.cuda.is_available()
                else "cpu").add_(1)
    s.stop()
