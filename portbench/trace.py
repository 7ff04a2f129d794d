"""The traced window: ``torch.profiler`` over it, reduced to the device's
busy time, its kernels, the operations that took the most device time,
and the longest idle gaps by what the host was doing.

The window is the span ``portbench.window`` that the harness records
around it; device operations are clipped to it.  The busy time is the
union of the device's operation intervals (kernels, copies, sets), so
overlapping operations count once.  An idle gap is named after the
innermost host event of the window's thread that covers its middle: a
torch operator, a CUDA runtime call, or one of the harness's own spans
(``portbench.*``) where the host ran Python that launched nothing.
"""

from __future__ import annotations

import bisect
from collections import Counter

import torch

WINDOW = "portbench.window"
#: entries of each list of the breakdown
TOP = 10
#: the longest gaps that are named and summed by name
NAMED_GAPS = 2000
#: host events searched back from a gap's middle for one that covers it
SEARCH = 4000
#: characters of a name kept in the breakdown
NAME_CHARS = 160


def profiler():
    """A profiler of host and device activity (entered by the caller)."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA])


def reduce(prof) -> dict:
    """``busy_s``, ``window_s``, ``kernels`` and ``device_events`` of the
    window, and ``device_ops`` and ``idle_gaps``, each a list of at most
    ``TOP`` ``[name, seconds]``."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    spans = set()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            dev.append((e.start_ns(), e.end_ns(), e.name(),
                        e.is_user_annotation()))
        else:
            host.append((e.start_ns(), e.end_ns(), e.name(),
                         e.start_thread_id()))
            if e.is_user_annotation():
                spans.add(e.name())
    # a span's image on the device's timeline is no operation
    dev = [d[:3] for d in dev if not d[3] and d[2] not in spans]
    win = [h for h in host if h[2] == WINDOW]
    if not win:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    w0, w1, _, tid = win[0]
    dev = sorted((max(a, w0), min(b, w1), n) for a, b, n in dev
                 if b > w0 and a < w1)
    busy, gaps, ops = 0, [], Counter()
    cur = w0
    for a, b, n in dev:
        ops[n] += b - a
        if a > cur:
            gaps.append((a - cur, cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if w1 > cur:
        gaps.append((w1 - cur, cur, w1))
    host = sorted(h[:3] for h in host if h[3] == tid and h[2] != WINDOW)
    starts = [h[0] for h in host]
    named = Counter()
    for length, a, b in sorted(gaps, reverse=True)[:NAMED_GAPS]:
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid) - 1
        label = WINDOW
        for j in range(i, max(i - SEARCH, -1), -1):
            if host[j][1] >= mid:
                label = host[j][2]
                break
        named[label[:NAME_CHARS]] += length
    kernels = sum(1 for _, _, n in dev
                  if not n.startswith(("Memcpy", "Memset")))
    return dict(busy_s=busy / 1e9, window_s=(w1 - w0) / 1e9,
                kernels=kernels, device_events=len(dev),
                device_ops=[[n[:NAME_CHARS], t / 1e9]
                            for n, t in ops.most_common(TOP)],
                idle_gaps=[[n, t / 1e9] for n, t in named.most_common(TOP)])
