"""The device trace of a traced run: ``torch.profiler`` over whole requests
of the window, reduced to the seconds in which an operation ran on each
card, device time by kernel, the longest idle gaps with what the host was
doing in them, and the kernels' share of their roofline."""

from __future__ import annotations

import torch

# The profiler loses a trace's first device records now and then; each trace
# opens with this many empty spin kernels, which no sum counts.
WARM_UP_LAUNCHES = 100
SPIN = "spin_kernel"
ANNOTATION = "bench:"  # the benchmark's spans (``record.Record.span``)


def start():
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    for _ in range(WARM_UP_LAUNCHES):
        torch.cuda._sleep(0)
    torch.cuda.synchronize()
    return prof


def _union(intervals) -> float:
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def stop(prof):
    prof.__exit__(None, None, None)
    return prof


def reduce(prof) -> dict:
    """Reduce a stopped profiler's events.  Times in seconds.

    ``busy_s`` is the mean over the cards of the union of the intervals in
    which a device operation (kernel, copy, fill) ran; ``window_s`` the span
    from the first to the last device or host event after the spin kernels."""
    events = prof.events()
    dev, host = [], []
    spin_end = 0.0
    for ev in events:
        tr = ev.time_range
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if SPIN in ev.name:
                spin_end = max(spin_end, tr.end)
                continue
            if ev.name.startswith(ANNOTATION):  # a host span's range on the device's timeline
                continue
            dev.append((tr.start, tr.end, ev.name, ev.device_index))
        else:
            host.append((tr.start, tr.end, ev.name))
    dev = [d for d in dev if d[0] >= spin_end]
    host = [h for h in host if h[0] >= spin_end]
    if not dev:
        return {"busy_s": 0.0, "window_s": 0.0, "kernel_s": {}, "device_ops": [], "idle_gaps": [],
                "cards": 0}
    t0 = min([d[0] for d in dev] + [h[0] for h in host])
    t1 = max([d[1] for d in dev] + [h[1] for h in host])
    cards = sorted({d[3] for d in dev})
    busy = [_union([(a, b) for a, b, _, i in dev if i == c]) for c in cards]
    kernel_s: dict = {}
    for a, b, name, _ in dev:
        kernel_s[name] = kernel_s.get(name, 0.0) + (b - a) * 1e-6
    # the longest gaps between device operations (on any card), each named by
    # the innermost host event running at its middle; inside a span of the
    # benchmark's own (``bench:*``) and no op of the program's, by the last op
    # that ended before it: the host was in the program's Python after it
    merged = []
    for a, b, _, _ in sorted(dev):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0])
                   for i in range(len(merged) - 1)), reverse=True)[:10]
    ops = sorted((ha, hb, name) for ha, hb, name in host if not name.startswith(ANNOTATION))
    idle = []
    for length, a, b in gaps:
        mid = (a + b) / 2
        covering = [(hb - ha, name) for ha, hb, name in host if ha <= mid <= hb]
        name = min(covering)[1] if covering else "host: no recorded event"
        if name.startswith(ANNOTATION):
            before = [n for ha, hb, n in ops if hb <= mid]
            name = f"{name} (Python after {before[-1] if before else 'its start'})"
        idle.append([name, length * 1e-6])
    top = sorted(kernel_s.items(), key=lambda kv: kv[1], reverse=True)[:10]
    top = [(name[:120], seconds) for name, seconds in top]
    return {
        "busy_s": sum(busy) / len(busy) * 1e-6,
        "window_s": (t1 - t0) * 1e-6,
        "kernel_s": kernel_s,
        "device_ops": [[k, v] for k, v in top],
        "idle_gaps": idle,
        "cards": len(cards),
    }


def kernel_seconds(kernel_s: dict, names) -> float:
    """Device seconds of the kernels whose profiler name holds one of
    ``names``."""
    return sum(s for k, s in kernel_s.items() if any(n in k for n in names))


def roofline_pct(run):
    """The kernels' share of their roofline in the traced requests: the least
    time of the counted work (``roofline.py``) over the device time of the
    kernels of its stages, in percent; None without a trace."""
    from .roofline import least_seconds

    rec = run.record
    if not rec.work or not rec.trace:
        return None
    names = [k for stage in {stage for stage, _, _ in rec.work} for k in run.stages[stage]]
    device = kernel_seconds(rec.trace["kernel_s"], names)
    if device <= 0:
        return None
    return 100.0 * sum(least_seconds(b, m) for _, b, m in rec.work) / device


def idle_pct(run):
    """The share of the traced window in which no operation ran on the card
    (the mean over the cards), in percent; None without a trace."""
    t = run.record.trace
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
