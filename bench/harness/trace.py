"""One fit under `torch.profiler`, reduced to what the per-layer metrics
read: device time by kernel name, device time under each host operator,
the device's busy seconds (the union of its kernels' intervals) and the
idle gaps labelled by what the host was doing.  Nothing is written to
disk: the trace lives in memory for one fit."""
from __future__ import annotations

import bisect
import dataclasses
import time
from collections import defaultdict


@dataclasses.dataclass
class TraceSummary:
    window_s: float                      # the traced fit's wall seconds
    busy_s: float                        # union of device intervals
    kernels: dict[str, tuple[float, int]]     # name -> (device s, calls)
    op_device_s: dict[str, tuple[float, int]]  # host op -> (its device s, calls)
    idle_gaps: list[tuple[str, float]]   # host activity -> idle s, largest first

    def kernel_time(self, *substrings: str) -> tuple[float, int]:
        """Device seconds and calls of every kernel whose name holds one of
        `substrings`."""
        s, n = 0.0, 0
        for name, (sec, calls) in self.kernels.items():
            if any(sub in name for sub in substrings):
                s, n = s + sec, n + calls
        return s, n

    def device_ops(self, top: int = 10) -> list[list]:
        rows = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])
        return [[name[:160], sec] for name, (sec, _) in rows[:top]]


def _union_length(intervals: list[tuple[float, float]]) -> tuple[float, list]:
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


def _host_activity(ops: list[tuple[float, float, str]], starts: list[float],
                   t: float, reach: int = 256) -> str:
    """The innermost host operator running at time `t`: of the operators
    (sorted by start) that began before `t`, the latest that is still
    running; only the `reach` latest are looked at."""
    i = bisect.bisect_right(starts, t)
    for a, b, name in reversed(ops[max(0, i - reach):i]):
        if b >= t:
            return name
    return "host (no operator)"


def reduce_profile(prof, window_s: float, device_type=None) -> TraceSummary:
    """Reduce a finished `torch.profiler.profile` to a `TraceSummary`.
    `device_type` is the `DeviceType` whose events count as device work
    (CUDA on the card; the CPU tests pass CPU operators of one name)."""
    from torch.autograd import DeviceType
    dev_t = DeviceType.CUDA if device_type is None else device_type
    kernels: dict[str, list] = defaultdict(lambda: [0.0, 0])
    dev_iv: list[tuple[float, float]] = []
    cpu_ops: list[tuple[float, float, str]] = []
    for ev in prof.events():
        a, b = ev.time_range.start, ev.time_range.end
        if ev.device_type == dev_t and dev_t != DeviceType.CPU:
            kernels[ev.name][0] += (b - a) * 1e-6
            kernels[ev.name][1] += 1
            dev_iv.append((a, b))
        elif ev.device_type == DeviceType.CPU:
            cpu_ops.append((a, b, ev.name))
    if dev_t == DeviceType.CPU:          # CPU tests: operators stand in
        for a, b, name in cpu_ops:
            if name.startswith("aten::"):
                kernels[name][0] += (b - a) * 1e-6
                kernels[name][1] += 1
                dev_iv.append((a, b))
    busy_us, merged = _union_length(dev_iv)
    gaps: dict[str, float] = defaultdict(float)
    if merged and cpu_ops:
        cpu_ops.sort()
        starts = [a for a, _, _ in cpu_ops]
        t0 = starts[0]
        t1 = max(max(b for _, b, _ in cpu_ops), merged[-1][1])
        edges = [t0] + [x for iv in merged for x in iv] + [t1]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                gaps[_host_activity(cpu_ops, starts, 0.5 * (a + b))] += \
                    (b - a) * 1e-6
    op_dev: dict[str, list] = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CPU and ev.device_time_total > 0:
            op_dev[ev.key] = [ev.device_time_total * 1e-6, ev.count]
    return TraceSummary(
        window_s=window_s, busy_s=busy_us * 1e-6,
        kernels={k: (v[0], v[1]) for k, v in kernels.items()},
        op_device_s={k: (v[0], v[1]) for k, v in op_dev.items()},
        idle_gaps=sorted(gaps.items(), key=lambda kv: -kv[1])[:10])


def traced(fn, *, device_type=None):
    """Run `fn()` once under `torch.profiler` (host operators and CUDA
    kernels); returns (its value, TraceSummary)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device_type is None:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        window_s = time.perf_counter() - t0
    return out, reduce_profile(prof, window_s, device_type)
