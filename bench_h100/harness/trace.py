"""The reduction of a ``torch.profiler`` capture to what the per-layer
readers read: the device's activity (kernels, copies, sets) inside the
traced window, the host's operators and the benchmark's own spans.

Events come from the profiler's in-memory results; no trace file is
written.  Timestamps are the profiler's nanoseconds, one clock for host
and device events."""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

DEVICE_KINDS = {"kernel": "kernel", "gpu_memcpy": "memcpy",
                "gpu_memset": "memset"}
HOST_KINDS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
SPAN_PREFIX = "bench."
NAME_CHARS = 160


def activity(e) -> str:
    """The event's kind: the profiler's own where it says it
    (``activity_type``, newer torch), else from the device, the
    user-annotation flag and the name, as the trace export sorts them."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    name = e.name()
    note = (e.is_user_annotation() if hasattr(e, "is_user_annotation")
            else name.startswith(SPAN_PREFIX))
    if "CUDA" in str(e.device_type()):
        if note:
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if note:
        return "user_annotation"
    if name.startswith("cu") and "::" not in name:
        return "cuda_runtime"
    return "cpu_op"


@dataclass
class Trace:
    """Device events (start, end, name, kind, correlation, linked) and
    host events (start, end, name, kind, thread, correlation), both sorted
    by start, and the window (start, end) of the span ``bench.traced``."""

    device: list = field(default_factory=list)
    host: list = field(default_factory=list)
    window: tuple = (0, 0)

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        dev, host = [], []
        for e in prof.profiler.kineto_results.events():
            kind = activity(e)
            start = e.start_ns()
            end = start + e.duration_ns()
            if kind in DEVICE_KINDS:
                dev.append((start, end, e.name(), DEVICE_KINDS[kind],
                            e.correlation_id(), e.linked_correlation_id()))
            elif kind in HOST_KINDS:
                host.append((start, end, e.name(), kind,
                             e.start_thread_id(), e.correlation_id()))
        dev.sort()
        host.sort()
        t = cls(dev, host)
        spans = t.spans("bench.traced")
        t.window = spans[0] if spans else (
            (dev[0][0], max(d[1] for d in dev)) if dev else (0, 0))
        return t

    def spans(self, name: str) -> list:
        """(start, end) of every host span called ``name``."""
        return [(s, e) for s, e, n, k, _, _ in self.host
                if k == "user_annotation" and n == name]

    def in_window(self, lo=None, hi=None) -> list:
        lo = self.window[0] if lo is None else lo
        hi = self.window[1] if hi is None else hi
        return [d for d in self.device if d[1] > lo and d[0] < hi]

    def busy_ns(self, lo=None, hi=None) -> int:
        """Length of the union of device activity inside [lo, hi]."""
        lo = self.window[0] if lo is None else lo
        hi = self.window[1] if hi is None else hi
        total, cur_s, cur_e = 0, None, None
        for s, e, _, _, _, _ in self.in_window(lo, hi):
            s, e = max(s, lo), min(e, hi)
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total

    def idle_gaps(self, lo=None, hi=None) -> list:
        """(start, end) of each stretch of [lo, hi] with no device
        activity."""
        lo = self.window[0] if lo is None else lo
        hi = self.window[1] if hi is None else hi
        gaps, edge = [], lo
        for s, e, _, _, _, _ in self.in_window(lo, hi):
            if s > edge:
                gaps.append((edge, s))
            edge = max(edge, e)
        if hi > edge:
            gaps.append((edge, hi))
        return gaps

    def host_at(self, t: int) -> str:
        """What the host was doing at ``t``: the benchmark's innermost span
        and the innermost operator or runtime call under way, on any
        thread."""
        span, op = None, None
        i = bisect.bisect_right(self.host, (t, float("inf")))
        best_span = best_op = None
        for s, e, n, k, _, _ in self.host[:i]:
            if e < t:
                continue
            if k == "user_annotation" and n.startswith(SPAN_PREFIX):
                if best_span is None or s >= best_span:
                    best_span, span = s, n
            elif k != "user_annotation":
                if best_op is None or s >= best_op:
                    best_op, op = s, n
        return f"{span or '-'} / {op or 'python'}"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time in the window, by
        name, and the longest idle gaps by what the host was doing."""
        by_name = {}
        for s, e, n, k, _, _ in self.in_window():
            key = n[:NAME_CHARS]
            by_name[key] = by_name.get(key, 0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n, ns / 1e9] for n, ns in ops],
                "idle_gaps": [[self.host_at(s + 1), (e - s) / 1e9]
                              for s, e in gaps]}

    def op_device_ns(self, op_name: str) -> tuple:
        """(device ns, kernels) of the kernels launched inside any host
        operator called ``op_name``: a kernel belongs to the operator when
        the runtime call that launched it (same correlation id) starts
        inside one of the operator's calls on the same thread."""
        ops = {}
        for s, e, n, k, tid, _ in self.host:
            if k == "cpu_op" and n == op_name:
                ops.setdefault(tid, []).append((s, e))
        launches = {c: (s, tid) for s, e, n, k, tid, c in self.host
                    if k in ("cuda_runtime", "cuda_driver")}
        total, count = 0, 0
        for s, e, n, kind, corr, linked in self.in_window():
            if kind != "kernel" or corr not in launches:
                continue
            t, tid = launches[corr]
            for a, b in ops.get(tid, ()):
                if a <= t <= b:
                    total += e - s
                    count += 1
                    break
        return total, count
