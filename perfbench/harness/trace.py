"""Reductions of a ``torch.profiler`` trace over whole traced epochs:
the device's busy time as the union of its operations' intervals inside
the traced window, the device operations that took most time, the longest
idle gaps by what the host was doing, and device time by kernel name."""

from __future__ import annotations

WINDOW = "perfbench.traced_window"
TICK = "perfbench.tick"
#: Longest operation name kept in the breakdown.
NAME_CHARS = 160


def _intervals(prof):
    """(window (start, end) in us, device [(start, end, name)], host
    [(start, end, name)]) of a finished profile."""
    from torch.autograd import DeviceType
    window, device, host = None, [], []
    for e in prof.events():
        rng = (e.time_range.start, e.time_range.end)
        if e.name == WINDOW and e.device_type == DeviceType.CPU:
            window = rng
        elif e.device_type == DeviceType.CUDA:
            # A host span's shadow on the device timeline is no work.
            if e.name not in (WINDOW, TICK) \
                    and not getattr(e, "is_user_annotation", False):
                device.append((*rng, e.name))
        elif e.device_type == DeviceType.CPU:
            host.append((*rng, e.name))
    if window is None:
        raise RuntimeError("the trace holds no traced-window span")
    lo, hi = window
    device = [(max(a, lo), min(b, hi), n) for a, b, n in device
              if b > lo and a < hi]
    return window, device, host


def _union(spans):
    merged = []
    for a, b, _n in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce(prof) -> dict:
    """``busy_s``, ``window_s``, ``kernels`` {name: (seconds, count)} and
    the ``breakdown`` of the traced window."""
    (lo, hi), device, host = _intervals(prof)
    merged = _union(device)
    busy = sum(b - a for a, b in merged)
    kernels: dict = {}
    for a, b, name in device:
        s, c = kernels.get(name, (0.0, 0))
        kernels[name] = (s + (b - a) / 1e6, c + 1)
    gaps, prev = [], lo
    for a, b in merged + [[hi, hi]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    by_host: dict = {}
    # Sweep the host's spans (nested per thread) with a stack of the open
    # ones; a gap belongs to the innermost span open at its middle.
    host = sorted(host)
    stack, at = [], 0
    for a, b in gaps:
        mid = (a + b) / 2
        while at < len(host) and host[at][0] <= mid:
            while stack and stack[-1][1] < host[at][0]:
                stack.pop()
            stack.append(host[at])
            at += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        doing = stack[-1][2] if stack else "host outside any traced op"
        by_host[doing] = by_host.get(doing, 0.0) + (b - a) / 1e6
    top_ops = sorted(((n[:NAME_CHARS], s) for n, (s, _c) in kernels.items()),
                     key=lambda x: -x[1])[:10]
    top_gaps = sorted(((n[:NAME_CHARS], s) for n, s in by_host.items()),
                      key=lambda x: -x[1])[:10]
    return {"busy_s": busy / 1e6, "window_s": (hi - lo) / 1e6,
            "kernels": kernels,
            "breakdown": {"device_ops": [[n, s] for n, s in top_ops],
                          "idle_gaps": [[n, s] for n, s in top_gaps]}}


class Marks:
    """The serving tick's ``mark`` hook: a CUDA event before each tick and
    after each of its legs, while ``on``."""

    def __init__(self) -> None:
        self.on = False
        self.ticks: list = []

    def _event(self, leg: str) -> None:
        import torch
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.ticks[-1].append((leg, ev))

    def begin(self) -> None:
        if self.on:
            self.ticks.append([])
            self._event("start")

    def __call__(self, leg: str) -> None:
        if self.on:
            self._event(leg)

    def legs(self) -> dict:
        """{leg: [ms of each marked tick]} (call after a synchronize)."""
        out: dict = {}
        for marks in self.ticks:
            for (_a, e0), (leg, e1) in zip(marks, marks[1:]):
                out.setdefault(leg, []).append(e0.elapsed_time(e1))
        return out
