"""One run of one cell: set-up, the measured window (a closed loop: one
client, the next request sent when the last completes), the trace in a
traced run, then the judgement against the plain reference once the window
has closed and the program's device state is freed."""

from __future__ import annotations

import gc
import hashlib
import os
import time

import torch

from . import cells, traffic, trace as tr
from .record import Record

HERE = cells.HERE
ROOT = os.path.dirname(HERE)
PROGRAM = "intmax_zkp_core_tpu_torch"
# whole requests of the window that a traced run profiles: the second and
# third (the first follows the set-up directly)
TRACED = (1, 3)


def source_digest(root: str = ROOT) -> str:
    """sha256 of the program's sources (paths and bytes), so that a changed
    tree never loads a circuit another tree built."""
    h = hashlib.sha256()
    base = os.path.join(root, PROGRAM)
    for dirpath, dirnames, filenames in sorted(os.walk(base)):
        dirnames[:] = sorted(d for d in dirnames if d not in ("_build", "__pycache__"))
        for name in sorted(filenames):
            if name.endswith((".py", ".cu", ".cuh", ".cpp", ".h")):
                path = os.path.join(dirpath, name)
                h.update(os.path.relpath(path, base).encode() + b"\0")
                with open(path, "rb") as fh:
                    h.update(fh.read())
    return h.hexdigest()[:16]


def circuit_cache_dir(root: str = ROOT) -> str:
    return os.path.join(HERE, ".circuits", source_digest(root))


def run_cell(bench: dict, cell: dict, seed: int, seconds: float, trace: bool, devices: list,
             t_start: float, root: str = ROOT, cache_dir: str | None = None,
             overrides: dict | None = None, rounds: int | None = None, base: str = HERE) -> dict:
    """One run: its ``setup_s``, ``window_s`` (the window's start to its last
    completion), ``memory_peak_bytes``, ``requests``, the ``record`` the
    metric readers read and the reference's ``judgement``.  ``overrides``
    changes the program's FRI parameters (the control); ``cache_dir`` is the
    circuit cache's folder (``None``: the checkout's, ``circuit_cache_dir``);
    ``rounds`` is the judge's rounds of verification (``None``: the
    configuration's); ``base`` is the folder whose ``traffic/`` and
    ``generators/`` hold the mix and its generator."""
    cfg = cells.config(bench, cell["config"], root)
    mix = cells.mix(cell["traffic"], base)
    module = cells.system(cfg)
    rec = Record()
    cache_dir = cache_dir or circuit_cache_dir(root)
    system = module.System(cfg, devices, cache_dir, rec, trace, overrides)
    system.setup(traffic.requests(mix, f"{seed}:warm", base))
    on_cuda = devices[0].type == "cuda"
    if on_cuda:
        for device in devices:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start

    requests = traffic.requests(mix, seed, base)
    outputs, work = [], []
    rec.open_window()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    t_last = t0
    prof = traced = None
    while time.perf_counter() < deadline or (trace and on_cuda and len(outputs) < TRACED[1]):
        req = next(requests)
        i = len(outputs)
        if trace and on_cuda and i == TRACED[0]:
            prof = tr.start()
        out = system.serve(req)
        t_last = time.perf_counter()
        outputs.append((req, out))
        rec.count("requests")
        if prof is not None and i + 1 == TRACED[1]:
            traced, prof = tr.stop(prof), None
        if trace and TRACED[0] <= i < TRACED[1]:
            work.extend(system.work(req, out))
    window_s = t_last - t0
    peak = max(torch.cuda.max_memory_allocated(d) for d in devices) if on_cuda else 0
    if traced is not None:  # reduced once the window has closed
        rec.trace = tr.reduce(traced)
    rec.work = work
    rec.window_s = window_s
    rec.setup_s = setup_s

    plain = system.plain_outputs(outputs)
    key = system.verifier_key()
    system.release()
    del outputs, system
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    judgement = module.judge(key, plain, seed,
                             cfg["judge"]["verify_rounds"] if rounds is None else rounds)
    judgement["seconds"] = time.perf_counter() - t_judge
    return {"setup_s": setup_s, "window_s": window_s, "record": rec, "judgement": judgement,
            "memory_peak_bytes": peak, "requests": len(plain)}
