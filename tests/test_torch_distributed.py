"""The port's mesh across two processes: the port of ``test_distributed.py``.
Two OS processes (``torch_distributed_worker.py``, run once for both tests)
join a gloo group on localhost through ``parallel/mesh.py::init_distributed``,
each with two CPU shards (a 2 x 2 mesh).

* The proof axis: K = 4 zkDSA witnesses proved with ``prove_batch(mesh=)``;
  the proofs each process gathered must equal single-process proofs (each
  worker proves half of them without a mesh) and the JAX package's
  (``golden/zkdsa_distributed_test.sha256``), bit for bit.
* The commit mesh across the processes, as 2 x 1 and 2 x 2 meshes: every
  rank's assembled LDE of seeded coefficients [9, 2^10] (rate bits 3) equals
  the JAX package's ``ops/ntt.py::coset_lde`` of the same numpy input, its
  Merkle levels (cap height 4) the port's unsharded ones; the four zkDSA
  witnesses proved under ``use_commit_mesh(mesh, min_lde=1)`` equal on both
  ranks, the single-process proofs and the golden.
"""

import hashlib
import json
import os
import pathlib
import pickle
import socket
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intmax_zkp_core_tpu.ops import ntt as jnt
from intmax_zkp_core_tpu_torch.engine.serde import proof_to_json
from intmax_zkp_core_tpu_torch.ops import goldilocks as gl
from intmax_zkp_core_tpu_torch.ops import merkle as tmk

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from torch_distributed_worker import CAP_HEIGHT, RATE_BITS, commit_coeffs  # noqa: E402

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
# Both workers' wall time together, the old limit of each: about 7x the
# 28-44 s this fixture's setup took in tier-1 runs (``--durations=0``) on
# 6 workers of a shared 8-core host, slow hours included.
WORKERS_TIMEOUT_S = 300


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    """Both ranks' results of one two-process run."""
    try:
        port = _free_port()
    except OSError:
        pytest.skip("no localhost port available")
    out_dir = tmp_path_factory.mktemp("workers")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT)] + env.get("PYTHONPATH", "").split(os.pathsep))
    worker = str(ROOT / "tests" / "torch_distributed_worker.py")
    procs = [
        subprocess.Popen([sys.executable, worker, str(rank), str(port), str(out_dir), "cpu",
                          "4", "test"],
                         env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)
    ]
    deadline = time.monotonic() + WORKERS_TIMEOUT_S  # one for both processes
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(0.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        outs = [p.communicate()[0] for p in procs]
        pytest.fail("distributed workers timed out\n" + "\n".join(outs))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker rc={p.returncode}\n{out}"
    results = []
    for rank in range(2):
        with open(out_dir / f"proofs.{rank}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


def _golden() -> list:
    lines = (ROOT / "intmax_zkp_core_tpu_torch" / "golden"
             / "zkdsa_distributed_test.sha256").read_text().splitlines()
    return [ln.split()[0] for ln in lines if not ln.startswith(("#", "circuit_digest"))]


def _sha(proof) -> str:
    return hashlib.sha256(json.dumps(proof_to_json(proof), sort_keys=True).encode()).hexdigest()


def test_two_process_proof_axis_equals_single_process_and_jax(workers):
    single = workers[0]["single"] + workers[1]["single"]
    assert len(single) == 4
    for rank, r in enumerate(workers):
        assert r["gathered"] == single, f"rank {rank}'s gathered proofs differ from one process's"
    assert [_sha(p) for p in single] == _golden()


def test_two_process_commit_mesh_equals_one_process_and_jax(workers):
    coeffs = commit_coeffs("test")
    want_lde = np.array(jnt.coset_lde(jnp.asarray(coeffs), RATE_BITS))
    want_levels = tmk.build_merkle_levels_batch(gl.from_u64(want_lde, "cpu").t()[None],
                                                CAP_HEIGHT)
    single = workers[0]["single"] + workers[1]["single"]
    for rank, r in enumerate(workers):
        for shards in ("2x1", "2x2"):
            got = r["commit"][shards, False]
            assert got["route"] == "gloo"
            assert (gl.to_u64(got["lde"]) == want_lde).all(), (rank, shards)
            assert len(got["levels"]) == len(want_levels) == 10
            for a, b in zip(got["levels"], want_levels):
                assert torch.equal(a, b[0]), (rank, shards)
            assert got["exchange_collectives"] > 0 and got["exchange_bytes"] > 0
            proofs = r["commit"][shards, "zkdsa"]
            assert proofs == workers[0]["commit"][shards, "zkdsa"] == single
    assert [_sha(p) for p in single] == _golden()
