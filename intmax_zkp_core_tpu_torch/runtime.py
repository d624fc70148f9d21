"""Warm-up for a long-lived prover: everything a first proof would otherwise
pay for before its own work, done once up front.

This is the one need of the JAX package's ``runtime.py`` that the port has.
Its flags (``serving_enabled``, ``poseidon_pallas_enabled``,
``gate_pallas_enabled``, ``perm_pallas_enabled``, ``enable_serving``) choose
between Pallas kernels and XLA graphs; here a wrapper launches its kernel
for a CUDA tensor and takes its plain version for a CPU tensor, so there is
nothing to choose.  Its persisted compiled programs (``engine/aot_cache.py``,
``ops/pallas_aot.py``) are carried by ``ops/cuda_build.py`` (the kernel
library under ``_build/``, rebuilt only when a source is newer) and
``native/loader.py`` (the host libraries, tagged by source, flags and CPU).
"""

from __future__ import annotations

import time

import torch

from .native.loader import load as load_native
from .ops import cuda_build as cb
from .ops import fri_init_cuda as fi
from .ops import gate_quotient_cuda as gqc
from .ops import goldilocks as gl
from .ops import ntt_cuda as nc
from .ops import perm_columns_cuda as pcol
from .ops import perm_quotient_cuda as pq
from .ops import poseidon_cuda as pc
from .ops import zinv_mul_cuda as zm


def _launch_each_kernel(device: torch.device) -> None:
    """One call of each of the eight kernel wrappers at a small shape (zeros
    and ones are field elements like any other)."""
    K, C, R, n, L = 1, 2, 8, 64, 512
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.int64, device=device)  # noqa: E731
    ones = lambda *shape: torch.ones(shape, dtype=torch.int64, device=device)  # noqa: E731
    pc.permute_cuda(zeros(n, 12))
    pc.hash_no_pad_cuda(zeros(n, 135))
    nc.ntt_cuda(zeros(2, 1 << (nc.LOCAL_LOG_MAX + 1)), False)
    pcol.perm_columns_cuda(ones(K, R, n), ones(K, C), ones(K, C), ones(R, n), ones(R, n))
    nch = pq.n_chunks(R)
    pq.perm_quotient_cuda(ones(K, R, L), ones(K, C, L), ones(K, C, nch - 1, L), ones(K, C),
                          ones(K, C), ones(K, C), ones(R, L), ones(L), ones(L), ones(R), 8)
    gqc.poseidon_gate_quotient_cuda(zeros(K, gqc.GATE.NUM_WIRES_USED, L), ones(L), ones(K, C),
                                    zeros(K, C, L), ones(K, C))
    zm.zinv_mul_cuda(ones(C, L), ones(L))
    fi.fri_initial_cuda(zeros(K, L, 2), zeros(K, L, 2), ones(L), zeros(K, 2), zeros(K, 2),
                        zeros(K, 2), zeros(K, 2))


def warmup(device=None, max_log_rows: int = 18) -> float:
    """Load (building where needed) the host libraries and, on a CUDA
    ``device`` (``None``: the CUDA device, raising without one), the kernel
    library; upload the per-device tables (the NTT's root powers and its
    four-step twiddles for every length up to 2^max_log_rows, both
    directions; the Poseidon and Poseidon-gate constants); launch each of the
    eight kernels once at a small shape and synchronize.  With
    ``device="cpu"`` only the host libraries are loaded.  Returns the
    wall-clock seconds."""
    t0 = time.perf_counter()
    device = gl.resolve_device(device)
    for name in ("poseidon", "witness"):
        load_native(name)
    if device.type == "cuda":
        if device.index is None:  # the tables are cached under the index a tensor reports
            device = torch.device("cuda", torch.cuda.current_device())
        cb.load()
        for inverse in (False, True):
            for log_n in range(max_log_rows + 1):
                if log_n <= nc.LOCAL_LOG_MAX:
                    nc.root_powers(log_n, inverse, device)
                else:
                    nc.fourstep_twiddles(log_n // 2, log_n - log_n // 2, inverse, device)
        _launch_each_kernel(device)
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0
