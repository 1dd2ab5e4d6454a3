"""The program's own spans in a reduced capture: the ``unet.*`` spans the
port records (``utils.profiling.annotate``) as ``user_annotation`` events
on the host, on the clock of the device's events.  The readers of the
program's spans (``metrics/*.py``) share this arithmetic.

A window that holds no ``unet.`` span reads as nothing (None): the
program recorded none, which is not a count of 0.  An idle gap of the
device is put down to the innermost ``unet.`` span open on the host at
its first nanosecond (the rule of ``Trace.host_at`` for the benchmark's
spans)."""

from __future__ import annotations

PREFIX = "unet."
SYNC = "unet.sync"
KERNEL1 = "unet.kernel1"


def spans(trace) -> list:
    """(start, end, name) of every program span in the traced window, by
    start, the longer first where two start together (the outer one)."""
    lo, hi = trace.window
    return sorted(((s, e, n) for s, e, n, k, _, _ in trace.host
                   if k == "user_annotation" and n.startswith(PREFIX)
                   and s < hi and e > lo), key=lambda sp: (sp[0], -sp[1]))


def inside(program: list, name: str, outer: list) -> list:
    """The spans called ``name`` of ``program`` that lie within one of the
    (start, end) spans ``outer``."""
    return [(s, e) for s, e, n in program if n == name
            and any(a <= s and e <= b for a, b in outer)]


def innermost(program: list, times: list) -> list:
    """The name of the innermost program span open at each of ``times``
    (sorted), or None; a span is open at t when start <= t <= end, and
    the innermost is the latest to start (the shorter of two that start
    together)."""
    names, open_, i = [], [], 0
    for t in times:
        while i < len(program) and program[i][0] <= t:
            open_.append(program[i])
            i += 1
        open_ = [sp for sp in open_ if sp[1] >= t]
        names.append(open_[-1][2] if open_ else None)
    return names


def idle_ns_under(trace, program: list, name: str, outer=None) -> int:
    """Device idle ns in the gaps whose first nanosecond falls under the
    program span ``name`` (innermost), over the window or within each of
    the (start, end) spans ``outer``."""
    if outer is None:
        gaps = trace.idle_gaps()
    else:
        gaps = sorted(g for lo, hi in outer for g in trace.idle_gaps(lo, hi))
    names = innermost(program, [s + 1 for s, _ in gaps])
    return sum(e - s for (s, e), n in zip(gaps, names) if n == name)


def sync_count(trace, outer_name: str):
    """(``unet.sync`` spans inside the spans ``outer_name``), or None
    without program spans."""
    program = spans(trace)
    if not program:
        return None
    return len(inside(program, SYNC, trace.spans(outer_name)))


def sync_idle_ns(trace, outer_name=None):
    """Device idle ns in gaps that begin under ``unet.sync`` (within the
    spans ``outer_name``, else over the window), or None without program
    spans."""
    program = spans(trace)
    if not program:
        return None
    outer = None if outer_name is None else trace.spans(outer_name)
    return idle_ns_under(trace, program, SYNC, outer)


def kernel1_host_us(trace, outer_name: str):
    """Mean host us of the ``unet.kernel1`` spans inside the spans
    ``outer_name``; None without program spans or without such a call
    (kernel 1 off the path)."""
    program = spans(trace)
    calls = inside(program, KERNEL1, trace.spans(outer_name))
    if not calls:
        return None
    return sum(e - s for s, e in calls) / len(calls) / 1e3
