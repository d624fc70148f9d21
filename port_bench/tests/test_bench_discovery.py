"""Cells, configurations, mixes, generators, metrics and roofline stages are
found by name: a dummy set added as files in a folder of its own, a mix of a
new kind with its generator among them, is taken with no file of the
benchmark changed."""

import json
import time

import torch

from port_bench import run as run_mod
from port_bench.harness import cells
from port_bench.harness.window import run_cell

METRIC = '''"""The requests the window served (a dummy reader)."""


def read(run):
    return float(run.record.counts.get("requests", 0)) or None
'''

GENERATOR = '''"""Batches of one SMT step: keys counting up from a drawn start (a dummy
kind)."""


def requests(mix, rng):
    key = rng.randrange(1 << mix["key_bits"])
    while True:
        key += 1
        yield [(key, (key, 1, 2, 3))]
'''


def test_dummy_set_from_a_folder(tmp_path):
    for sub in ("traffic", "generators", "metrics", "configs", "roofline/stages"):
        (tmp_path / sub).mkdir(parents=True)
    with open(f"{cells.HERE}/tests/smt_process_8.json") as fh:
        cfg = {**json.load(fh), "name": "dummy_config"}
    (tmp_path / "configs" / "dummy_config.json").write_text(json.dumps(cfg))
    (tmp_path / "traffic" / "dummy_mix.json").write_text(
        json.dumps({"kind": "dummy_kind", "key_bits": 5}))
    (tmp_path / "generators" / "dummy_kind.py").write_text(GENERATOR)
    (tmp_path / "metrics" / "dummy_requests.py").write_text(METRIC)
    (tmp_path / "roofline" / "stages" / "dummy_stage.json").write_text(
        json.dumps({"kernels": ["dummy_kernel"]}))
    with open(f"{run_mod.ROOT}/BENCHMARK.json") as fh:
        bench = json.load(fh)
    cell = {"name": "dummy.cell", "config": "dummy_config", "traffic": "dummy_mix", "chips": 1,
            "why": "a dummy cell"}
    bench["configs"].append({"name": "dummy_config", "file": str(tmp_path / "configs/dummy_config.json"),
                             "reduced": []})
    bench["workloads"].append(cell)
    for name in ("dummy_requests", "dummy_requests.split"):  # the second shares the reader
        bench["per_layer"].append({"name": name, "unit": "requests", "better": "higher",
                                   "source": "program_counter", "layer": "application",
                                   "moves": "setup_s", "workloads": ["dummy.cell"]})
    assert cells.workload(bench, "dummy.cell") is cell
    assert cells.mix("dummy_mix", str(tmp_path))["kind"] == "dummy_kind"
    assert "dummy_stage" in cells.stages(str(tmp_path)) and "merkle" in cells.stages(str(tmp_path))
    names = [m["name"] for m in cells.per_layer(bench, cell)]
    assert {"dummy_requests", "dummy_requests.split", "circuit_load_s"} <= set(names)
    assert "tensor_ms.proofs" not in names  # listed for its own cells only

    result = run_cell(bench, cell, 7, 0.1, True, [torch.device("cpu")], time.perf_counter(),
                      cache_dir=str(tmp_path / "circuits"), base=str(tmp_path))
    line = run_mod.result_line(bench, cell, result, True, "cpu", 1, base=str(tmp_path))
    assert line["correct"]
    assert line["correct"] and result["judgement"]["attempted"] == 1
    assert line["metrics"]["dummy_requests"] == {"value": 1.0, "unit": "requests"}
    assert line["metrics"]["dummy_requests.split"] == {"value": 1.0, "unit": "requests"}
    assert "circuit_load_s" in line["metrics"]
    assert list(line)[-1] == "checks"
    assert set(line) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
