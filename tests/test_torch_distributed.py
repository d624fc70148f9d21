"""The port's proof axis across two processes: the port of
``test_distributed.py``.  Two OS processes (``torch_distributed_worker.py``)
join a gloo group on localhost through ``parallel/mesh.py::init_distributed``,
each with two CPU shards (a 2 x 2 mesh), and prove K = 4 zkDSA witnesses with
``prove_batch(mesh=)``; the proofs each process gathered must equal
single-process proofs (each worker proves half of them without a mesh) and
the JAX package's (``golden/zkdsa_distributed_test.sha256``), bit for bit."""

import hashlib
import json
import os
import pathlib
import pickle
import socket
import subprocess
import sys

import pytest
import torch

from intmax_zkp_core_tpu_torch.engine.serde import proof_to_json

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORKER_TIMEOUT_S = 300


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_proof_axis_equals_single_process_and_jax(tmp_path):
    try:
        port = _free_port()
    except OSError:
        pytest.skip("no localhost port available")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT)] + env.get("PYTHONPATH", "").split(os.pathsep))
    worker = str(ROOT / "tests" / "torch_distributed_worker.py")
    procs = [
        subprocess.Popen([sys.executable, worker, str(rank), str(port), str(tmp_path), "cpu",
                          "4", "test"],
                         env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)
    ]
    outs = []
    try:
        for p in procs:  # each process its own timeout
            outs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker rc={p.returncode}\n{out}"

    golden = [ln for ln in (ROOT / "intmax_zkp_core_tpu_torch" / "golden"
                            / "zkdsa_distributed_test.sha256").read_text().splitlines()
              if not ln.startswith("#")]
    results = []
    for rank in range(2):
        with open(tmp_path / f"proofs.{rank}.pkl", "rb") as f:
            results.append(pickle.load(f))
    single = results[0]["single"] + results[1]["single"]
    assert len(single) == 4
    for rank, r in enumerate(results):
        assert r["gathered"] == single, f"rank {rank}'s gathered proofs differ from one process's"
    for proof, line in zip(single, golden[1:]):
        sha = hashlib.sha256(json.dumps(proof_to_json(proof), sort_keys=True).encode()).hexdigest()
        assert sha == line.split()[0]
