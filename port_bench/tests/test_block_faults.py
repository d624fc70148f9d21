"""A whole run of the block flow's cell on the CPU, the look for a card
skipped: the deployment's constants and circuits, each witness checked
(``check_witness``) instead of proved and the block circuit in its
trusted-aggregation form, so that the plain reference judges the
statements alone (the proofs' verification is the SMT tests'): sound it is
correct; with the timed path broken underneath it is not."""

import json
import os
import time

import pytest
import torch

from port_bench import run as run_mod
from port_bench.harness.window import run_cell
from port_bench.systems import block_flow

CONFIG = "port_bench/tests/block_circuit_test_cpu.json"


def checked(data, pws, timings=None):
    from intmax_zkp_core_tpu_torch.models.recursion.gadgets import CheckedPublicInputs

    return [CheckedPublicInputs(public_inputs=data.check_witness(pw)) for pw in pws]


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("circuits"))


def set_prover(monkeypatch, prove):
    from intmax_zkp_core_tpu_torch.engine import prover

    monkeypatch.setattr(prover, "prove_batch", prove)


@pytest.fixture
def bench(monkeypatch):
    set_prover(monkeypatch, checked)
    monkeypatch.setattr(block_flow.System, "plain_outputs", lambda self, outputs: [
        (scn, {k: [{"public_inputs": [int(x) for x in p.public_inputs]} for p in out[k]]
               for k in block_flow.KINDS}) for scn, out in outputs])
    monkeypatch.setattr(block_flow.System, "verifier_key", lambda self: {})
    with open(os.path.join(run_mod.ROOT, "BENCHMARK.json")) as fh:
        real = json.load(fh)
    cell = {"name": "block.test", "config": "block_test", "traffic": "block_one", "chips": 1,
            "why": "test"}
    return {**real, "configs": [{"name": "block_test", "file": CONFIG, "reduced": []}],
            "workloads": [cell]}, cell


def correct(bench, cache):
    b, cell = bench
    result = run_cell(b, cell, 2147483693, 0.1, False, [torch.device("cpu")],
                      time.perf_counter(), cache_dir=cache, rounds=0)
    line = run_mod.result_line(b, cell, result, False, "cpu", 1)
    return line["correct"], line["checks"]


def test_sound_block_is_correct(bench, cache):
    ok, checks = correct(bench, cache)
    assert ok, checks


def test_state_left_unchanged(bench, cache, monkeypatch):
    """Every request after the first answers with the first's outputs."""
    real = block_flow.System.serve
    first = {}

    def stale(self, scn):
        out = real(self, scn)
        return first.setdefault(self.rec.in_window, out)

    monkeypatch.setattr(block_flow.System, "serve", stale)
    b, cell = bench
    result = run_cell(b, cell, 2147483693, 2.0, False, [torch.device("cpu")],
                      time.perf_counter(), cache_dir=cache, rounds=0)
    assert result["requests"] >= 2
    checks = result["judgement"]["checks"]
    assert checks["statement"][0] > 0


def last_call(fault):
    """``fault`` planted in the block proof's call (K = 1), whose output
    nothing later in the flow reads."""
    def prove(data, pws, timings=None):
        out = checked(data, pws, timings)
        return fault(out) if data.common.num_public_inputs == 4 else out  # the entry hash
    return prove


def test_half_the_batch_left_out(bench, cache, monkeypatch):
    set_prover(monkeypatch, last_call(lambda out: out[: len(out) // 2]))
    ok, checks = correct(bench, cache)
    assert not ok and checks["missing"]["value"] > 0


def test_answer_altered(bench, cache, monkeypatch):
    def altered(out):
        out[-1].public_inputs[0] = (out[-1].public_inputs[0] + 1) % 0xFFFFFFFF00000001
        return out

    set_prover(monkeypatch, last_call(altered))
    ok, checks = correct(bench, cache)
    assert not ok and checks["statement"]["value"] > 0
