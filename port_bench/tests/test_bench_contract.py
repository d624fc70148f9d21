"""BENCHMARK.json against the files it names: every configuration, mix,
system and metric reader exists, every name is well formed, and every cell
reports setup_s, another end-to-end metric and a per-layer one."""

import json
import os
import re

import pytest

from port_bench.harness import cells

ROOT = os.path.dirname(cells.HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.fixture(scope="module")
def bench():
    return cells.load_bench(ROOT)


def test_names_and_files(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    for entry in bench["configs"]:
        assert NAME.match(entry["name"])
        assert entry["file"].startswith("port_bench/")
        cfg = cells.config(bench, entry["name"], ROOT)
        assert cfg["reduced"] == entry["reduced"]
        assert os.path.exists(os.path.join(cells.HERE, "systems", f"{cfg['system']}.py"))
    for cell in bench["workloads"]:
        assert NAME.match(cell["name"]) and cell["chips"] in (1, 4)
        assert len(cell["why"]) <= 200
        cells.mix(cell["traffic"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"])
        assert cells.metric_reader(m["name"]).read is not None


def test_every_cell_reports(bench):
    for cell in bench["workloads"]:
        e2e = [m["name"] for m in cells.end_to_end(bench, cell)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cells.per_layer(bench, cell)
        for m in cells.per_layer(bench, cell):
            assert m["moves"] in e2e, (cell["name"], m["name"])


def test_stages_name_kernels():
    stages = cells.stages()
    assert {"merkle", "lde", "perm_columns", "perm_quotient", "zinv_mul", "fri_initial",
            "gate_quotient"} <= set(stages)
    assert all(stages.values())


def test_bench_file_is_json():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        assert json.load(fh)["command"] == ["python3", "port_bench/run.py"]
