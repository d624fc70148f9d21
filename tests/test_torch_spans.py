"""The port's span recorder (``engine/spans.py``) and the spans the prover
records with it.

One batch of the arithmetic circuit (K = 2) is proved twice: under
``spans.recording()`` with ``timings=``, and with neither.  Checked: no
``torch.cuda.synchronize`` anywhere; with neither, no profiler range and no
CUDA event; the proofs equal; the ``prover:`` phases tile the batch and
their parts tile each phase; every ``prover:transcript`` span sits in a
phase; ``fetches`` counts every ``gl.to_u64`` of the batch and nothing
outside a recording.  A timer on a CUDA device is driven with stand-in
events: its values are the events' elapsed times, taken only at
``close()``.  Two threads record at once, each with its own parent stack.
``experiments/span_split.py``'s reduction of a synthetic profiler trace
counts no program range as device time and names each idle stretch by the
innermost program span open on the host.
"""

import importlib.util
import inspect
import pathlib
import threading
from types import SimpleNamespace

import pytest
import torch

from intmax_zkp_core_tpu_torch.engine import prover, spans
from intmax_zkp_core_tpu_torch.engine.batch_prover import prove_batch
from intmax_zkp_core_tpu_torch.engine.circuit import CircuitBuilder
from intmax_zkp_core_tpu_torch.engine.config import CircuitConfig, FriConfig
from intmax_zkp_core_tpu_torch.engine.witness import PartialWitness
from intmax_zkp_core_tpu_torch.ops import goldilocks as gl

torch.set_num_threads(1)

PHASES = ("tables", "witness", "commit_wires", "perm_columns", "quotient", "openings", "fri")
PARTS = {
    "quotient": ("perm", "gates", "finish", "commit"),
    "fri": ("combine", "initial", "fold", "grind", "queries"),
}


def _refuse(*args, **kwargs):
    raise AssertionError("called where nothing may be")


def _arith():
    """x * y + x with x, y and the result public, and two witnesses."""
    builder = CircuitBuilder(
        CircuitConfig(fri=FriConfig(num_query_rounds=6, proof_of_work_bits=4)), device="cpu")
    x, y = builder.add_virtual_target(), builder.add_virtual_target()
    z = builder.add(builder.mul(x, y), x)
    for t in (x, y, z):
        builder.register_public_input(t)
    data = builder.build()
    pws = []
    for xv, yv in ((3, 5), (7, 11)):
        pw = PartialWitness()
        pw.set_target(x, xv)
        pw.set_target(y, yv)
        pws.append(pw)
    return data, pws


@pytest.fixture(scope="module")
def batch():
    """(proofs recorded, proofs with neither, timings, spans, counters, the
    to_u64 calls a wrapper saw inside the recording, the recorder's counters
    after a to_u64 outside it)."""
    data, pws = _arith()
    calls = []
    real = gl.to_u64

    def counted(t):
        calls.append(t.shape)
        return real(t)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "synchronize", _refuse)
        mp.setattr(gl, "to_u64", counted)
        timings = {}
        with spans.recording() as rec:
            on = prove_batch(data, pws, timings=timings)
        recorded, counters = rec.take()
        seen = len(calls)
        gl.to_u64(torch.zeros(3, dtype=torch.int64))
        after = dict(rec.counters)
        mp.setattr(torch.profiler, "record_function", _refuse)
        mp.setattr(torch.cuda, "Event", _refuse)
        off = prove_batch(data, pws)
    return on, off, timings, recorded, counters, seen, after


def test_spans_and_timer_never_synchronize_the_device():
    source = inspect.getsource(spans)
    assert "torch.cuda.synchronize" not in source
    assert prover.PhaseTimer is spans.PhaseTimer


def test_recorded_proofs_equal_unrecorded(batch):
    on, off = batch[:2]
    assert on == off


def test_phases_tile_the_batch_and_parts_tile_their_phase(batch):
    timings, recorded = batch[2], batch[3]
    assert len({s.timer for s in recorded}) == 1
    phases = [s for s in recorded if s.parent is None]
    assert [s.name for s in phases] == [f"prover:{p}" for p in PHASES]
    for a, b in zip(phases, phases[1:]):
        assert a.end == b.start
    for phase in phases:
        key = phase.name.split(":")[1]
        parts = [s for s in recorded if s.parent is phase and "/" in s.name]
        assert [s.name for s in parts] == [f"{phase.name}/{p}" for p in PARTS.get(key, ())]
        if parts:
            assert parts[0].start == phase.start and parts[-1].end == phase.end
            for a, b in zip(parts, parts[1:]):
                assert a.end == b.start
            for p, s in zip(PARTS[key], parts):
                assert timings[f"{key}_{p}"] == s.seconds
            assert timings[key] == sum(s.seconds for s in parts)
        else:
            assert timings[key] == phase.seconds


def test_transcript_spans_sit_in_a_phase(batch):
    recorded = batch[3]
    transcripts = [s for s in recorded if s.name == spans.TRANSCRIPT]
    # commit_wires, perm_columns, quotient/commit, openings, two in
    # fri/combine, fri/fold's layers and final polynomial, a grind and the
    # queries
    assert len(transcripts) >= 10
    places = {s.parent.name for s in transcripts}
    assert places >= {"prover:commit_wires", "prover:perm_columns", "prover:quotient/commit",
                      "prover:openings", "prover:fri/combine", "prover:fri/fold",
                      "prover:fri/grind", "prover:fri/queries"}
    for s in transcripts:
        assert s.parent.name.startswith("prover:")
        assert s.parent.name not in (spans.TRANSCRIPT, spans.FETCH)
    own = spans.self_seconds(recorded)[spans.TRANSCRIPT]
    fetched = sum(s.end - s.start for s in recorded
                  if s.name == spans.FETCH and s.parent.name == spans.TRANSCRIPT)
    total = sum(s.end - s.start for s in transcripts)
    assert own == pytest.approx(total - fetched, abs=1e-9)


def test_fetches_count_every_crossing_and_none_outside(batch):
    recorded, counters, seen, after = batch[3:]
    assert seen > 0
    assert counters["fetches"] == seen
    assert sum(s.name == spans.FETCH for s in recorded) == seen
    assert counters["fetch_s"] == pytest.approx(
        sum(s.end - s.start for s in recorded if s.name == spans.FETCH), abs=1e-9)
    assert after == {}


class _FakeEvent:
    """A CUDA event on a stand-in clock: each record takes the next tick of
    ``clock`` (milliseconds)."""

    clock = [0.0]
    log: list = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.at = None

    def record(self, stream=None):
        self.clock[0] += 3.0
        self.at = self.clock[0]
        self.log.append("record")

    def synchronize(self):
        self.log.append("synchronize")

    def elapsed_time(self, end):
        return end.at - self.at


def test_timer_on_a_cuda_device_reads_events_only_at_close(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", _refuse)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    _FakeEvent.log = []
    timings = {}
    timer = spans.PhaseTimer(timings, torch.device("cuda"))
    timer.phase("a")
    timer.phase("b", "b_x")
    timer.sub("b_y")
    assert "synchronize" not in _FakeEvent.log
    timer.close()
    # one event a boundary, 3 ms apart: a, b_x, b_y each one tick
    assert _FakeEvent.log.count("record") == 4
    assert timings == {"a": 0.003, "b_x": 0.003, "b_y": 0.003, "b": 0.006}


def test_nothing_is_made_with_no_recorder_and_no_dict(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _refuse)
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    timer = spans.PhaseTimer(None, torch.device("cuda"))
    timer.phase("a", "a_x")
    timer.sub("a_y")
    timer.close()
    with spans.span(spans.TRANSCRIPT), spans.fetch():
        spans.count("fetches")
    assert spans.span("x") is spans.fetch()


def test_parent_stack_is_per_thread():
    barrier = threading.Barrier(2, timeout=10)

    def work(tag):
        with spans.span(f"{tag}:outer"):
            barrier.wait()
            with spans.span(f"{tag}:inner"):
                barrier.wait()
            barrier.wait()

    with spans.recording() as rec:
        threads = [threading.Thread(target=work, args=(tag,)) for tag in "ab"]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    recorded, _ = rec.take()
    parents = {s.name: s.parent and s.parent.name for s in recorded}
    assert parents == {"a:outer": None, "a:inner": "a:outer",
                       "b:outer": None, "b:inner": "b:outer"}


def _event(name, a, b, cuda=False, thread=1):
    kind = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=name, device_type=kind, thread=thread,
                           time_range=SimpleNamespace(start=a, end=b))


def test_idle_is_named_by_the_innermost_program_span():
    path = pathlib.Path(__file__).resolve().parent.parent / "experiments" / "span_split.py"
    spec = importlib.util.spec_from_file_location("span_split", path)
    split = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(split)
    events = [
        _event("spin_kernel", 0, 1, cuda=True),
        _event("bench:prove", 10, 100),
        _event("prover:quotient", 12, 60),
        _event("prover:quotient/gates", 12, 60),
        _event("aten::add", 13, 14),
        _event("prover:transcript", 60, 80),
        _event("prover:witness", 80, 95),
        _event("kernel_a", 12, 20, cuda=True),
        _event("prover:quotient/gates", 12, 45, cuda=True),  # its device-side range
        _event("kernel_b", 40, 45, cuda=True),
        _event("kernel_c", 62, 64, cuda=True),
    ]
    red = split.reduce(events)
    us = {k: round(v * 1e6, 6) for k, v in red["idle"].items()}
    assert round(red["busy_s"] * 1e6, 6) == 15 and round(red["window_s"] * 1e6, 6) == 90
    assert us == {"prover:quotient/gates": 35, "prover:transcript": 18, "prover:witness": 15,
                  "bench:prove": 7}
    assert round(split.idle_launch_s(red["idle"]) * 1e6, 6) == 35
