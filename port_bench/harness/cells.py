"""Discovery by name: a cell is an entry of ``BENCHMARK.json``; its
configuration is the file that entry names; its traffic mix is
``traffic/<mix>.json``, whose ``kind`` names ``generators/<kind>.py``; a
metric is ``metrics/<metric>.py`` (or, for a metric split by the rate it
moves, ``metrics/<metric before the first dot>.py``); a configuration's
``system`` is ``systems/<system>.py``; a roofline stage is
``roofline/stages/<stage>.json``.  Adding any of them adds files and
entries and edits none."""

from __future__ import annotations

import glob
import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # port_bench/


class CellError(LookupError):
    pass


def load_bench(root: str) -> dict:
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(path):
        raise CellError(f"no BENCHMARK.json at {root}")
    with open(path) as fh:
        return json.load(fh)


def workload(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise CellError(f"no workload named {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: str) -> dict:
    for entry in bench["configs"]:
        if entry["name"] == name:
            with open(os.path.join(root, entry["file"])) as fh:
                return json.load(fh)
    raise CellError(f"no configuration named {name!r} in BENCHMARK.json")


def _find(base: str, *parts) -> str | None:
    """``base``/parts, else this folder's (a folder of added files, such as
    a test's, sees this folder's files too)."""
    for root in dict.fromkeys((base, HERE)):
        path = os.path.join(root, *parts)
        if os.path.exists(path):
            return path
    return None


def mix(name: str, base: str = HERE) -> dict:
    path = _find(base, "traffic", f"{name}.json")
    if path is None:
        raise CellError(f"no traffic mix {name!r}")
    with open(path) as fh:
        return json.load(fh)


def _reported(metric: dict, cell: dict, bench: dict) -> bool:
    """A metric is read in a cell its ``workloads`` names, or, without that
    key, wherever the cell reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell["name"] in metric["workloads"]
    moves = metric.get("moves")
    if moves is None:
        return True
    target = next(m for m in bench["end_to_end"] if m["name"] == moves)
    return _reported(target, cell, bench)


def end_to_end(bench: dict, cell: dict) -> list:
    return [m for m in bench["end_to_end"] if _reported(m, cell, bench)]


def per_layer(bench: dict, cell: dict) -> list:
    return [m for m in bench["per_layer"] if _reported(m, cell, bench)]


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str, base: str = HERE):
    """The module of ``metrics/<name>.py``, else of the reader shared by the
    parts of a split name, ``metrics/<name before the first dot>.py``.  Its
    ``read(run)`` returns the number, or None where the run gives it nothing
    to read."""
    for stem in dict.fromkeys((name, name.split(".")[0])):
        path = _find(base, "metrics", f"{stem}.py")
        if path is not None:
            return _load(path, f"port_bench_metric_{stem}")
    raise CellError(f"no metric reader {name!r}")


def generator(kind: str, base: str = HERE):
    """The module of ``generators/<kind>.py``, whose ``requests(mix, rng)``
    yields a mix's requests."""
    path = _find(base, "generators", f"{kind}.py")
    if path is None:
        raise CellError(f"no traffic generator {kind!r}")
    return _load(path, f"port_bench_generator_{kind}")


def system(cfg: dict):
    """The module ``port_bench.systems.<system>`` that serves ``cfg``."""
    return importlib.import_module(f"port_bench.systems.{cfg['system']}")


def stages(base: str = HERE) -> dict:
    """stage -> the kernel names (as the profiler sees them) that do its
    work."""
    out = {}
    paths = glob.glob(os.path.join(HERE, "roofline", "stages", "*.json"))
    if base != HERE:
        paths += glob.glob(os.path.join(base, "roofline", "stages", "*.json"))
    for path in paths:
        with open(path) as fh:
            out[os.path.splitext(os.path.basename(path))[0]] = json.load(fh)["kernels"]
    return out
