"""A whole run of a cell, the look for a card skipped, at a size a CPU holds
(the SMT process-proof circuit at n_levels=8, batches of 2): sound it comes
out correct; with the timed path broken underneath it comes out not
correct, once for each fault an SMT cell can have, and for the control (the
proof of work ground to 8 bits where the configuration states 16)."""

import json
import os
import time

import pytest
import torch

from port_bench import run as run_mod
from port_bench.harness.window import run_cell

CONFIG = "port_bench/tests/smt_process_8.json"


def bench(tmp_path):
    (tmp_path / "traffic").mkdir(exist_ok=True)
    mix = {"kind": "smt_set", "batch": 2, "key_bits": 7}
    (tmp_path / "traffic" / "smt_k2_test.json").write_text(json.dumps(mix))
    with open(os.path.join(run_mod.ROOT, "BENCHMARK.json")) as fh:
        real = json.load(fh)
    cell = {"name": "smt8.test", "config": "smt_process_8", "traffic": "smt_k2_test", "chips": 1,
            "why": "test"}
    return {**real, "configs": [{"name": "smt_process_8", "file": CONFIG, "reduced": []}],
            "workloads": [cell]}, cell


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("circuits"))


def correct(tmp_path, cache, **kw):
    b, cell = bench(tmp_path)
    result = run_cell(b, cell, 2147483659, 0.1, False, [torch.device("cpu")],
                      time.perf_counter(), cache_dir=cache, base=str(tmp_path), **kw)
    line = run_mod.result_line(b, cell, result, False, "cpu", 1, base=str(tmp_path))
    return line["correct"], line["checks"]


def test_sound_run_is_correct(tmp_path, cache):
    ok, checks = correct(tmp_path, cache)
    assert ok, checks


def test_state_left_unchanged(tmp_path, cache, monkeypatch):
    from intmax_zkp_core_tpu_torch.bin import verify_smt_process as vsp
    from intmax_zkp_core_tpu_torch.models.sparse_merkle_tree import SparseMerkleTree

    real = vsp.step
    monkeypatch.setattr(vsp, "step", lambda tree, target, k, v: real(SparseMerkleTree(), target,
                                                                     k, v))
    ok, checks = correct(tmp_path, cache)
    assert not ok and checks["statement"]["value"] > 0


def test_half_the_batch_left_out(tmp_path, cache, monkeypatch):
    from intmax_zkp_core_tpu_torch.engine import prover

    real = prover.prove_batch
    monkeypatch.setattr(prover, "prove_batch",
                        lambda data, pws, **kw: real(data, pws[: len(pws) // 2], **kw))
    ok, checks = correct(tmp_path, cache)
    assert not ok and checks["missing"]["value"] > 0


@pytest.mark.parametrize("lane", [0, 1])
def test_answer_altered(tmp_path, cache, monkeypatch, lane):
    """One lane of every batch answers wrong: the judge verifies a proof at
    each lane, so it sees whichever lane it is."""
    from intmax_zkp_core_tpu_torch.engine import prover

    real = prover.prove_batch

    def altered(data, pws, **kw):
        out = real(data, pws, **kw)
        c0, c1 = out[lane].openings["wires"][0]
        out[lane].openings["wires"][0] = ((c0 + 1) % 0xFFFFFFFF00000001, c1)
        return out

    monkeypatch.setattr(prover, "prove_batch", altered)
    ok, checks = correct(tmp_path, cache)
    assert not ok and checks["rejected"]["value"] > 0


def test_control_is_not_correct(tmp_path, cache):
    from port_bench.control import DEFAULT_BREAK

    ok, checks = correct(tmp_path, cache, overrides=DEFAULT_BREAK)
    assert not ok and checks["rejected"]["value"] > 0
