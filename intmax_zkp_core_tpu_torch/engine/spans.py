"""The port's one span recorder: named, nested intervals of the prover and
its callers, counters beside them, and ``PhaseTimer``, the timer the prover
and the block flow keep their phases with.

``recording()`` makes a ``Recorder`` active for the process.  While one is
active:

* ``span(name)`` (a ``with`` block) records its name, its parent (the open
  span of its thread, a per-thread stack), the id of the ``PhaseTimer`` --
  a ``prove_batch`` call, or a flow's stages -- it was opened under, and its
  host start and end (``time.perf_counter``); under a timer on a CUDA device
  also one ``torch.cuda.Event(enable_timing=True)`` at each end, recorded on
  the device's current stream.  Events are never waited for while the timer
  runs: its ``close()`` resolves them once, after the batch's last fetch,
  when the card has already run everything they mark.  Each span also opens
  a ``torch.profiler.record_function`` range under its name, so a profiler
  trace shows what the program was doing on the profiler's own clock;
* ``fetch()`` is the span ``prover:fetch`` around a device -> host copy
  (``ops/goldilocks.py::to_u64``, the prover's one crossing) and adds to the
  counters ``fetches`` and ``fetch_s`` (host seconds inside the copy, which
  include the wait for the work queued before it);
* ``count(name, n)`` adds to a counter.

The spans and counters stay in memory until the caller takes them
(``Recorder.take``).  With no recorder active each hook is one check of a
module global and returns: nothing is allocated, no event is created and no
profiler range is opened.
"""

from __future__ import annotations

import itertools
import threading
import time
from contextlib import contextmanager

import torch

_active = None  # the Recorder of the innermost ``recording()``, or None
_local = threading.local()  # .stack: this thread's open spans, innermost last
_timer_ids = itertools.count(1)

FETCH = "prover:fetch"
TRANSCRIPT = "prover:transcript"  # the prover's host-only stretches


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Recorder:
    """The closed spans (in the order they closed, from every thread) and
    the counters of one ``recording()``."""

    def __init__(self):
        self.spans: list = []
        self.counters: dict = {}
        self._lock = threading.Lock()

    def count(self, name: str, n=1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def _keep(self, spans) -> None:
        with self._lock:
            self.spans.extend(spans)

    def take(self) -> tuple:
        """(spans, counters) recorded so far, which the recorder forgets."""
        with self._lock:
            out = self.spans, self.counters
            self.spans, self.counters = [], {}
        return out


@contextmanager
def recording():
    """Make a new ``Recorder`` active for the process while the block runs;
    yields it."""
    global _active
    rec, prev = Recorder(), _active
    _active = rec
    try:
        yield rec
    finally:
        _active = prev


class _Off:
    """The span of no recorder: a ``with`` block that records nothing."""

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class Span:
    """One named interval.  ``parent`` is the span that was open on its
    thread when it opened (None at the top), ``timer`` the id of the
    ``PhaseTimer`` it was opened under (None outside one), ``start`` and
    ``end`` host seconds, ``seconds`` its length on the device's timeline
    once its timer has resolved it (host seconds without a CUDA device)."""

    __slots__ = ("name", "parent", "timer", "start", "end", "seconds",
                 "_rec", "_owner", "_events", "_range", "_counted")

    def __init__(self, name: str, rec, counted: bool = False):
        self.name = name
        self._rec = rec
        self._counted = counted
        self.parent = self.timer = self._owner = self._events = self._range = None
        self.start = self.end = self.seconds = None

    def _open(self, event=None, owner=None, at=None) -> None:
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self._owner = owner if owner is not None else (self.parent and self.parent._owner)
        if self._owner is not None:
            self.timer = self._owner.id
            self._owner._spans.append(self)
            if self._owner.cuda:
                self._events = [event if event is not None else self._owner._event(), None]
        if self._rec is not None:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        stack.append(self)
        self.start = time.perf_counter() if at is None else at

    def _close(self, event=None, at=None) -> None:
        self.end = time.perf_counter() if at is None else at
        if self._events is not None:
            self._events[1] = event if event is not None else self._owner._event()
        stack = _stack()
        if self in stack:
            del stack[stack.index(self):]
        if self._range is not None:
            self._range.__exit__(None, None, None)
        if self._counted:
            self._rec.count("fetches")
            self._rec.count("fetch_s", self.end - self.start)
        if self._owner is None:
            self.seconds = self.end - self.start
            if self._rec is not None:
                self._rec._keep([self])

    def __enter__(self):
        self._open()
        return self

    def __exit__(self, *exc):
        self._close()
        return False


def span(name: str):
    """A ``with`` block recorded as the span ``name`` while a recorder is
    active."""
    rec = _active
    if rec is None:
        return _OFF
    return Span(name, rec)


def fetch():
    """The span ``prover:fetch`` and its two counters, around one device ->
    host copy, while a recorder is active."""
    rec = _active
    if rec is None:
        return _OFF
    return Span(FETCH, rec, counted=True)


def count(name: str, n=1) -> None:
    """Add ``n`` to the active recorder's counter ``name``."""
    rec = _active
    if rec is not None:
        rec.count(name, n)


def self_seconds(spans) -> dict:
    """Host seconds by span name, each span's length less the part its child
    spans cover (children nest inside their parent, one thread each)."""
    given = set(map(id, spans))
    out: dict = {}
    for s in spans:
        out[s.name] = out.get(s.name, 0.0) + (s.end - s.start)
        if id(s.parent) in given:
            out[s.parent.name] = out.get(s.parent.name, 0.0) - (s.end - s.start)
    return out


class PhaseTimer:
    """Seconds per phase, and per part of a phase, of one run of phases on
    one device, into a caller's dict: the prover's phases of one
    ``prove_batch`` (``prefix`` "prover"), or a flow's stages.

    Each phase is the span ``<prefix>:<phase>`` and each part the span
    ``<prefix>:<phase>/<part>`` (``<part>`` less a leading ``<phase>_``),
    recorded whenever a dict is given or a recorder is active; the dict's
    keys are the names given to ``phase`` and ``sub``.  A boundary takes one
    host stamp and, on a CUDA device, one CUDA event on the device's current
    stream, never waited for: nothing synchronizes the card.  ``close()``
    resolves the events once, after the last fetch, and gives each phase's
    seconds on the device's timeline -- from the card reaching the phase's
    first boundary to its reaching the last -- or, on the CPU, on the host's
    clock.  A host-only phase, such as the witness fill, reads the host's
    time, since the card waits for it.  A phase with parts is the sum of its
    parts, so they add up exactly.  With no dict and no recorder every
    method returns at once."""

    def __init__(self, timings, device, prefix: str = "prover"):
        self.timings = timings
        self.rec = _active
        self.on = timings is not None or self.rec is not None
        if not self.on:
            return
        self.id = next(_timer_ids)
        self.prefix = prefix
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self._spans: list = []  # every span opened under the timer
        self._keys: dict = {}  # phase or part span -> its key in the dict
        self._open: list = []  # the open phase's span, then its open part's
        self._base = len(_stack())

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def _event(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _stamp(self) -> tuple:
        """One boundary: a CUDA event on the device's stream, and the host
        clock."""
        return self._event() if self.cuda else None, time.perf_counter()

    def _start(self, key: str, name: str, stamp) -> None:
        s = Span(name, self.rec)
        s._open(stamp[0], self, stamp[1])
        self._keys[s] = key
        self._open.append(s)

    def phase(self, name, first_part=None) -> None:
        """A new phase begins, with its first part if it has parts (and the
        open phase, with its open part, ends)."""
        if not self.on:
            return
        stamp = self._boundary()
        self._start(name, f"{self.prefix}:{name}", stamp)
        if first_part is not None:
            self._start(first_part, self._part(name, first_part), stamp)

    def sub(self, name) -> None:
        """A new part of the open phase begins (and the open part ends)."""
        if not self.on:
            return
        stamp = self._stamp()
        if len(self._open) > 1:
            self._open.pop()._close(*stamp)
        del _stack()[self._base + 1:]
        self._start(name, self._part(self._keys[self._open[0]], name), stamp)

    def _boundary(self) -> tuple:
        """End the open phase and its open part at one stamp; drop what an
        unclosed span left above the timer on the thread's stack."""
        stamp = self._stamp()
        for s in reversed(self._open):
            s._close(*stamp)
        self._open = []
        del _stack()[self._base:]
        return stamp

    def _part(self, phase: str, part: str) -> str:
        short = part[len(phase) + 1:] if part.startswith(phase + "_") else part
        return f"{self.prefix}:{phase}/{short}"

    def close(self) -> None:
        """End the open phase, resolve every span opened under the timer,
        write the dict and hand the spans to the active recorder."""
        if not self.on or self._spans is None:
            return
        self._boundary()
        spans, self._spans = self._spans, None
        for s in spans:
            if s._events is None:
                s.seconds = s.end - s.start
            else:
                start, end = s._events
                end.synchronize()  # long done: the batch ended in a fetch
                s.seconds = start.elapsed_time(end) * 1e-3
                s._events = None
        if self.timings is not None:
            keyed = self._keys
            sums: dict = {}
            for s, key in keyed.items():
                if s.parent in keyed:  # a part: it adds to its phase
                    self.timings[key] = self.timings.get(key, 0.0) + s.seconds
                    sums[s.parent] = sums.get(s.parent, 0.0) + s.seconds
            for s, key in keyed.items():
                if s.parent not in keyed:
                    self.timings[key] = self.timings.get(key, 0.0) + sums.get(s, s.seconds)
        if self.rec is not None:
            self.rec._keep(spans)
