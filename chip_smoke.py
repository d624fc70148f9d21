#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--log-rows N] [--ptxas]

Builds the CUDA kernels from ``intmax_zkp_core_tpu_torch/csrc`` with nvcc,
holds each against its plain PyTorch version on the card (bit-identical:
tolerance 0), then drives the port's main path — build a circuit, prove,
verify — for the zkDSA signature circuit and for a Poseidon hash-chain
circuit of 2^N rows (default 15) at
``CircuitConfig.standard_recursion_config()``.  Prints one line per phase, a
JSON line describing every kernel, and a last JSON line ``{"ok": true, ...}``.
Any failed phase raises and the script exits non-zero; without a CUDA device
it exits 1 at once.

Eight kernels are built and held: the Poseidon permutation and sponge, the
four of the permutation argument (permutation columns, permutation terms of
the quotient, the divide by Z_H, the initial FRI quotient), the Poseidon
gate's share of the quotient and the NTT.  The host C++ (``native/``: the
Poseidon permutation and sponge of the transcript and the host tree walks,
and the witness-generation engine) is built with g++ and held against the
Python versions (``[native]``, ``[chain-witness]``).

A second path runs after the chain: the SMT process-proof loop of
``bin/verify_smt_process.py`` at n_levels=256 and
``standard_recursion_config`` (``[smt]``), whose first proof must hash to
``golden/smt_process_256_standard.sha256`` (made by the JAX package).  The
launch counts are set to 0 before each path and read after it.

A third path, the user-tx path, runs the block flow's first stages
(``models/rollup/block_flow.py::prove_user_txs_and_signatures`` at
``RollupConstants.test_constants()``): the user-transaction circuit of
4,096 rows, its three witnesses proved as one batch (``prove_batch``, K = 3,
``[user-tx]``), the proposal, and the two signatures as a second batch, once
in each sponge wiring (``[signatures]``).  Every batch proof must equal a
sequential proof of its witness and the hash in
``golden/user_tx_flow_standard.sha256`` (made by the JAX package), and K3 -
K7 must be launched as often per batch as per single proof.

A fourth path, the block path, finishes the flow on those stages
(``run_block_flow(prove=True, recursive=True, stages=...)``, the counterpart
of the reference's ``src/bin/block_circuit.rs``): the recursive block
circuit at ``test_constants`` (65,536 rows, LDE 2^19; four user-tx and four
zkDSA proofs verified in the circuit) is built, its witness set, proved in
the chained wiring and verified (``[block]``, ``[block-phases]``), proved
again in the fused wiring (``[block-fused]``), and the batch proof of
``bin/block_circuit.py`` (``prove_batch_over``: two slots, the second
disabled; ``[batch]``) made over it.  The block circuit's and the batch
circuit's digests and both proofs' hashes must equal
``golden/block_flow_standard.sha256`` (made by the JAX package),
``BlockInfo`` the committed ``test_cases/block1_info.json``, and the block's
public input the entry hash of the JAX package's check mode; tampered
proofs are rejected.  Both proofs are made once more through the plain
versions on the card and must be equal (``[block-plain]``), and one more
block proof of each wiring is timed (``[kernel-time] path=block``).

Every kernel is held against its plain version at the shapes of each path
(the chain's 2^N rows, the SMT circuit's 2^12, LDE 8x, the K = 3 user-tx
batch's and the block circuit's 2^16); each such comparison's line names
its path.

Two lines describe the kernels' code and where the device time of a proof
goes: ``[sass]`` counts the SASS instructions, IMAD-class instructions,
registers and stack bytes of every kernel of the library (``cuobjdump``),
and ``[kernel-time]``, after one more chain proof of each sponge wiring, one
more user-tx batch and proof and one more block proof of each wiring, gives
each kernel's device milliseconds (``torch.profiler``, from a trace whose
events equal the launches: ``profiled_run``) and launches per proof or
batch, and the device milliseconds of all kernels.

In the kernels line ``max_abs_err`` is the largest absolute difference
between a kernel's output and its plain version's, taken on the int64 bit
patterns in float64 over every shape compared; the script fails unless it
is 0.  ``bound_ms`` counts the bytes the function must move and the
multiply-adds of the cheapest known way to compute it,
``bound_ms_as_computed`` the multiply-adds of the kernels' own algorithm.
"""

from __future__ import annotations

import argparse
import hashlib
import itertools
import json
import re
import shutil
import os
import subprocess
import sys
import time

import numpy as np
import torch

P = 0xFFFFFFFF00000001

# Peak rates of one H100 SXM used for the bounds (dense, at the full power
# limit): device memory 3.35 TB/s; 32-bit integer multiply-adds at half the
# float32 FMA rate (67 TFLOP/s = 33.5e12 FMA/s over 128 FP32 lanes per SM;
# the SM has 64 INT32 lanes) = 16.75e12 per second.
HBM_BYTES_PER_S = 3.35e12
INT32_MAD_PER_S = 16.75e12
# 32-bit multiply-adds that one permutation needs, by the cheapest known
# formulation (the sparse factorisation of the partial rounds that
# ``ops/poseidon_fast.py::permute_fast_s`` carries):
#   118 S-boxes (8*12 full + 22 partial), x^7 as two squarings of 3 distinct
#     partial products and two multiplies of 4;
#   8 full-round MDS layers of 12*12 + 1 small constants x 2 limbs;
#   one 11x11 layer of full 64-bit constants before the partial rounds;
#   22 partial rounds of 11 + 11 multiplies by 64-bit constants and one by a
#     small constant.
SBOXES = 8 * 12 + 22
MDS_LAYER_MADS = (12 * 12 + 1) * 2
MADS_PER_PERMUTATION = (
    SBOXES * (2 * 3 + 2 * 4) + 8 * MDS_LAYER_MADS + 11 * 11 * 4 + 22 * (22 * 4 + 2)
)
# What the kernels' own algorithm spends (csrc/poseidon.cu): the same form,
# except that M00 of each partial round is multiplied as a full 64-bit
# constant (4 partial products, not 2).  Reported beside the bound, never as
# the bound.
MADS_AS_COMPUTED = MADS_PER_PERMUTATION + 22 * 2


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


def toolchain_probe(nvcc: str) -> dict:
    """nvcc's release line and whether the triton package is installed (the
    port does not use Triton; the probe only records what the machine has)."""
    import importlib.metadata
    import importlib.util

    out = subprocess.run([nvcc, "--version"], capture_output=True, text=True, timeout=60).stdout
    release = next((ln.strip() for ln in out.splitlines() if "release" in ln), "unknown")
    if importlib.util.find_spec("triton") is None:
        triton = "absent"
    else:
        triton = importlib.metadata.version("triton")
    return {"nvcc": "'" + release + "'", "triton": triton}


def find_cuobjdump(nvcc: str) -> str | None:
    """The toolkit's cuobjdump: on the PATH or beside nvcc."""
    beside = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    return shutil.which("cuobjdump") or (beside if os.path.isfile(beside) else None)


def kernel_name(symbol: str) -> str:
    """The name of a kernel from its mangled symbol (``_Z14permute_kernelPKy...``
    -> ``permute_kernel``; a template's integer arguments kept,
    ``_Z16ntt_local_kernelILi9ELb0ELb0EEv...`` -> ``ntt_local_kernel<9,0,0>``); other
    symbols as they are."""
    m = re.match(r"_Z(\d+)", symbol)
    if not m:
        return symbol
    end = m.end() + int(m.group(1))
    args = re.match(r"I((?:L[a-z]-?\d+E)+)E", symbol[end:])
    if args:
        values = re.findall(r"L[a-z](-?\d+)E", args.group(1))
        return f"{symbol[m.end():end]}<{','.join(values)}>"
    return symbol[m.end():end]


def sass_counts(library: str, cuobjdump: str) -> dict:
    """For each kernel in ``library``: SASS instructions (no NOP), the
    IMAD-class ones among them (IMAD, IMAD.WIDE, IMAD.HI, IMAD.X; not
    IMAD.MOV, which is a move) with the .WIDE and .HI forms counted apart,
    and the registers and stack bytes of ``cuobjdump -res-usage``."""
    def run(flag):
        return subprocess.run([cuobjdump, flag, library], capture_output=True, text=True,
                              timeout=300, check=True).stdout

    counts, c = {}, None
    for line in run("-sass").splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            c = counts[kernel_name(fn.group(1))] = {
                "instructions": 0, "imad": 0, "imad_wide": 0, "imad_hi": 0}
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if c is None or ins is None or ins.group(1) == "NOP":
            continue
        op = ins.group(1)
        c["instructions"] += 1
        if op.startswith("IMAD") and not op.startswith("IMAD.MOV"):
            c["imad"] += 1
            c["imad_wide"] += ".WIDE" in op
            c["imad_hi"] += ".HI" in op
    name = None
    for line in run("-res-usage").splitlines():
        fn = re.search(r"Function (\S+):", line)
        if fn:
            name = kernel_name(fn.group(1))
            continue
        use = re.search(r"REG:(\d+) STACK:(\d+)", line)
        if name in counts and use:
            counts[name].update(registers=int(use.group(1)), stack_bytes=int(use.group(2)))
    return counts


def rand_field(rng, shape, device, loose: bool = False) -> torch.Tensor:
    """Canonical field elements with lanes of 0 and p-1 mixed in; with
    ``loose``, a third of the lanes in [p, 2^64) instead, p and 2^64-1 among
    them (u64 values that are not canonical, which the Poseidon kernels
    take)."""
    from intmax_zkp_core_tpu_torch.ops import goldilocks as gl

    a = rng.integers(0, P, size=shape, dtype=np.uint64)
    flat = a.reshape(-1)
    flat[:: 7] = 0
    flat[3 :: 11] = P - 1
    if loose:
        high = rng.integers(P, 1 << 64, size=flat.shape, dtype=np.uint64, endpoint=False)
        flat[1 :: 3] = high[1 :: 3]
        flat[1 :: 13] = P
        flat[2 :: 17] = (1 << 64) - 1
    return gl.from_u64(a, device)


def mismatches(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a != b).sum().item())


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| over the int64 bit patterns, in float64."""
    return float((a.double() - b.double()).abs().max().item())


def time_ms(fn, reps: int, flush: torch.Tensor | None = None) -> float:
    """Median milliseconds of ``fn()`` on the card over ``reps`` runs (CUDA
    events; one warm-up; the L2 cache is overwritten between runs when a
    flush buffer is given).  The events bracket the whole call, so a wrapper's
    host work counts where the card waits for it; the median keeps one stalled
    call out of the time of a kernel of some tens of microseconds."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(n_bytes: float, mads: float, mads_as_computed: float,
          bytes_as_computed: float | None = None) -> dict:
    """The least time the card could take: the larger of the bytes that must
    move (each input read once, each output written once) over the memory
    rate and the needed 32-bit multiply-adds over the integer rate.  The
    second figure takes the kernel's own multiply-adds and, where it moves
    more, its own bytes."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = mads / INT32_MAD_PER_S * 1e3
    moved_ms = (n_bytes if bytes_as_computed is None else bytes_as_computed) / HBM_BYTES_PER_S * 1e3
    return {
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "bound_ms_as_computed": max(mads_as_computed / INT32_MAD_PER_S * 1e3, moved_ms),
    }


def bound_ms(rows: int, width_in: int, width_out: int, perms_per_row: int) -> dict:
    """The bound of a Poseidon kernel over ``rows`` rows."""
    perms = rows * perms_per_row
    return bound(rows * (width_in + width_out) * 8, perms * MADS_PER_PERMUTATION,
                 perms * MADS_AS_COMPUTED)


# A field multiply counts as 4 multiply-adds (the partial products of a
# 64x64 product) and a squaring as 3.  A Fermat chain (64 squarings and 10
# multiplies) counts 232.  An inverse by the cheapest formulation known (one
# chain per batch of values and three multiplies per further value -
# Montgomery's batch inversion, the batch taken without limit) counts 12.  As
# the kernels compute it, K3 spends one chain per point, K6 and K7 one per
# block (``block_batch_inverse``).
MUL, SQR = 4, 3
CHAIN = 64 * SQR + 10 * MUL
INV_BATCHED = 3 * MUL


def block_batch_inverse(n_values: int, layout: tuple, per_thread: int) -> int:
    """Multiply-adds of ``goldilocks.cuh::batch_inv_loose`` over ``n_values``
    values, ``per_thread`` a thread, in blocks of ``layout[0]`` threads: a
    thread's running product and walk back (three multiplies a further
    value), the block's two warp scans, the product of the other warps'
    totals and three multiplies a thread, and one chain a block."""
    threads = layout[0]
    blocks = -(-n_values // (threads * per_thread))
    scans = 2 * (32).bit_length() - 2 + threads // 32 - 1 + 3
    return blocks * CHAIN + blocks * threads * scans * MUL + n_values * INV_BATCHED


def perm_columns_bound(K: int, C: int, R: int, n: int) -> dict:
    """K3, the whole function: wires, id and sigma read once (not once per
    challenge), z, pp and wrap written once.  Per point and challenge: two
    factor multiplies per wire, the chunk products, the prefix products of
    the f- and g-chunks, the suffix products G_suff[j+1], two multiplies for
    each q_j and one for the row quotient, one for the running product, and
    z * q_j.  As computed (``csrc/perm_columns.cu``) the running product is
    pass A's block scan (five warp steps, the products of up to three warps'
    totals before the thread, of all four and the exclusive one) and pass C's
    carry multiply, the inverse a Fermat chain, and the kernels move more:
    each challenge's threads load the wires, id and sigma (the L2 cache
    serves the second challenge at the main path's shape), F_pref and the g
    chunks are parked in device memory and read back, and z and the q_j go
    through device memory between passes A and C."""
    nch = (R + 6) // 7
    n_bytes = (K * R + 2 * R) * n * 8 + K * C * nch * n * 8 + K * C * 8
    common = (2 * R + 2 * (R - nch) + 2 * (nch - 1) + max(nch - 2, 0) + 2 * (nch - 1) + 1
              + (nch - 1))
    points = K * C * n
    # per point and challenge: 3 R loads; parks 2 nch - 3 written and read
    # back, q_j and z written by pass A, read and written again by pass C
    moved = points * 8 * (3 * R + 2 * (2 * nch - 3) + 3 * nch) + K * C * 8
    return bound(n_bytes, points * ((common + 1) * MUL + INV_BATCHED),
                 points * ((common + 5 + 3 + 4 + 1 + 1) * MUL + CHAIN), moved)


def perm_quotient_bound(K: int, C: int, R: int, L: int) -> dict:
    """K5: the first R wire rows, sigma, xs and l0 read once; Z, the partial
    products read and acc written once per (proof, challenge)."""
    nch = (R + 6) // 7
    n_bytes = (K * R + R + 2) * L * 8 + K * C * (nch + 1) * L * 8 + (4 * K * C + R) * 8
    # two factor multiplies per wire, chunk products, two products and one
    # alpha multiply per chunk, and the L_0 term with its alpha multiply
    muls = 2 * R + 2 * (R - nch) + 3 * nch + 2
    mads = K * C * L * muls * MUL
    return bound(n_bytes, mads, mads)


def zinv_mul_bound(rows: int, L: int, distinct: int, layout: tuple) -> dict:
    """K6: acc read, out written, z_h read; ``distinct`` values of z_h need an
    inverse (on the prover's coset Z_H takes only ``blowup`` values).  As
    computed, a batch inverse of every z_h value in the kernel's ``layout``
    (threads a block, points a thread)."""
    n_bytes = (2 * rows + 1) * L * 8
    return bound(n_bytes, distinct * CHAIN + rows * L * MUL,
                 block_batch_inverse(L, layout, layout[1]) + rows * L * MUL)


def fri_initial_bound(K: int, L: int, layout: tuple) -> dict:
    """K7: comb1, comb2 read and G written as pairs, xs read.  As computed
    (``csrc/fri_init.cu``), per term three multiplies for the inverse's
    components (7 z1 / N among them) and the four products of the sums, and
    a batch inverse of the two norms of every point in the kernel's
    ``layout`` (threads a block, points a thread)."""
    n_bytes = K * L * 3 * 16 + L * 8 + K * 8 * 8
    # per term: the square of the norm, two multiplies for the inverse's
    # components, four for the extension product and one by the small constant 7
    term = SQR + 2 * MUL + 4 * MUL + 2
    return bound(n_bytes, K * L * 2 * (term + INV_BATCHED),
                 K * L * 2 * (SQR + 7 * MUL) + K * block_batch_inverse(2 * L, layout, 2 * layout[1]))


def gate_quotient_bound(K: int, C: int, L: int) -> dict:
    """K4: the gate's 135 wire rows, sel, acc read once and acc written once.
    Per point: 118 S-boxes (two squarings, two multiplies), 7 dense MDS layers
    of small constants (two limb products per entry), the table products of
    PARTIAL_A / PARTIAL_B (a coefficient below 2^32 as 2 multiply-adds, else
    4), the swap square and four delta multiplies, and 123 C fold and C
    selector multiplies.  As computed (``csrc/gate_quotient.cu``) every table
    product is a full one (the dense rows, a GlDot term each)."""
    from intmax_zkp_core_tpu_torch.ops import gate_quotient_cuda as gqc

    W, n_cs = gqc.GATE.NUM_WIRES_USED, gqc.N_CS
    coef = [c for row in gqc.affine_tables()[1] for c in row if c]
    small = sum(1 for c in coef if c < (1 << 32))
    n_bytes = (K * W * L + L + 2 * K * C * L) * 8 + 4 * K * C * 8
    common = 7 * MDS_LAYER_MADS + SQR + 4 * MUL + (n_cs * C + C) * MUL
    mads = SBOXES * (2 * SQR + 2 * MUL) + small * 2 + (len(coef) - small) * MUL + common
    as_computed = SBOXES * (2 * SQR + 2 * MUL) + len(coef) * MUL + common
    return bound(n_bytes, K * L * mads, K * L * as_computed)


def ntt_bound(B: int, n: int, inverse: bool) -> dict:
    """K2: [B, n] read once and written once; (n/2) log2 n twiddle multiplies
    per row.  As computed (``csrc/ntt.cu``) the four-step moves the rows
    twice; each local transform of 2^M points spends, per 8 points, 0, 0, 2
    or 5 products in a first pass of 0 to 3 stages and 12 in each later pass
    (7 twiddles, 5 inside the stages); the four-step adds its twiddle per
    point, the one-launch inverse its scale."""
    from intmax_zkp_core_tpu_torch.ops import ntt_cuda as nc

    log_n = n.bit_length() - 1
    mads = B * (n // 2) * log_n * MUL
    halves = [log_n] if log_n <= nc.LOCAL_LOG_MAX else [log_n // 2, log_n - log_n // 2]
    per_8 = 0
    for log_len in halves:
        first, *later = nc.passes_for(log_len)
        per_8 += (0, 0, 2, 5)[first] + 12 * len(later)
    per_8 += 8 if len(halves) == 2 or inverse else 0
    return bound(2 * B * n * 8, mads, B * n * per_8 // 8 * MUL, 2 * len(halves) * B * n * 8)


def proof_sha256(proof) -> str:
    from intmax_zkp_core_tpu_torch.engine.serde import proof_to_json

    return hashlib.sha256(json.dumps(proof_to_json(proof), sort_keys=True).encode()).hexdigest()


def expect_rejected(circuit, proof) -> None:
    """A proof with one opening changed must not verify."""
    import copy

    bad = copy.deepcopy(proof)
    c0, c1 = bad.openings["wires"][0]
    bad.openings["wires"][0] = ((c0 + 1) % P, c1)
    try:
        circuit.verify(bad)
    except AssertionError:
        return
    raise RuntimeError("a tampered proof was accepted")


def expect_per_proof(before: dict, after: dict, what: str) -> None:
    """One proof calls each kernel of the permutation argument and the
    Poseidon-gate kernel once (``launches_per_proof``)."""
    for name, want in launches_per_proof().items():
        if after[name] - before[name] != want:
            raise RuntimeError(
                f"the {what} proof launched {name} {after[name] - before[name]} times, not {want}")


def path_tag(path) -> dict:
    """The log field naming the main path whose shape a hold is at."""
    return {"path": path} if path else {}


def path_sizes(paths: dict, shift: int = 0) -> list:
    """(2^(log_rows + shift), path) of each main path, by name."""
    return [(1 << (log_rows + shift), path) for path, log_rows in paths.items()]


def phase_kernels(device, rng, paths):
    """K1 and K1b against their plain versions: batch sizes that the block of
    128 rows does and does not divide, sponge widths 1 - 135 contiguous and
    as a transposed view, and at the shapes of each main path (``paths``:
    name -> log2 rows): the permutations of its LDE leaves' chained sponge
    and of its first tree level, the fused sponge over its leaves of 135, 24
    and 16 columns (transposed views) and its tree-level pairs."""
    from intmax_zkp_core_tpu_torch.ops import goldilocks as gl
    from intmax_zkp_core_tpu_torch.ops import poseidon as ps
    from intmax_zkp_core_tpu_torch.ops import poseidon_cuda as pc

    worst = {"permute_cuda": 0, "hash_no_pad_cuda": 0}
    err = {"permute_cuda": 0.0, "hash_no_pad_cuda": 0.0}
    # canonical inputs and inputs with lanes in [p, 2^64), at batch sizes
    # that the kernels' block of 128 rows does and does not divide
    for B, loose in itertools.product((1, 127, 255, 256, 1 << 14, (1 << 18) + 3), (False, True)):
        x = rand_field(rng, (B, 12), device, loose)
        got, want = pc.permute_cuda(x), pc.permute_plain(x)
        bad = mismatches(got, want)
        worst["permute_cuda"] = max(worst["permute_cuda"], bad)
        err["permute_cuda"] = max(err["permute_cuda"], max_abs_err(got, want))
        log("kernels", kernel="permute_cuda", plain="ops.poseidon.permute", B=B, loose=loose,
            mismatches=bad)
    # width 1 and 9: partial last chunks of one lane
    for width in (1, 2, 5, 8, 9, 12, 16, 24, 100, 135):
        for B, loose in ((1, True), (4099, True), (1 << 18, False), (1 << 18, True)):
            x = rand_field(rng, (B, width), device, loose)
            want = pc.hash_no_pad_plain(x)
            got = pc.hash_no_pad_cuda(x)
            bad = mismatches(got, want)
            # the same rows handed over as the transposed view of [width, B]
            got_t = pc.hash_no_pad_cuda(x.t().contiguous().t())
            bad_t = mismatches(got_t, want)
            # and the chained route (one permutation launch per absorb step)
            got_c = ps.hash_no_pad(x)
            bad_c = mismatches(got_c, want)
            worst["hash_no_pad_cuda"] = max(worst["hash_no_pad_cuda"], bad, bad_t)
            worst["permute_cuda"] = max(worst["permute_cuda"], bad_c)
            err["hash_no_pad_cuda"] = max(
                err["hash_no_pad_cuda"], max_abs_err(got, want), max_abs_err(got_t, want)
            )
            err["permute_cuda"] = max(err["permute_cuda"], max_abs_err(got_c, want))
            log("kernels", kernel="hash_no_pad_cuda", plain="ops.poseidon.hash_no_pad",
                width=width, B=B, loose=loose, mismatches=bad, mismatches_strided=bad_t,
                mismatches_chained=bad_c)
    for L, path in path_sizes(paths, 3):
        for B in (L // 2, L):
            x = rand_field(rng, (B, 12), device)
            got, want = pc.permute_cuda(x), pc.permute_plain(x)
            bad = mismatches(got, want)
            worst["permute_cuda"] = max(worst["permute_cuda"], bad)
            err["permute_cuda"] = max(err["permute_cuda"], max_abs_err(got, want))
            log("kernels", kernel="permute_cuda", plain="ops.poseidon.permute", B=B, path=path,
                mismatches=bad)
        for width, strided in ((135, True), (24, True), (16, True), (8, False)):
            x = rand_field(rng, (width, L) if strided else (L, width), device)
            x = x.t() if strided else x
            got, want = pc.hash_no_pad_cuda(x), pc.hash_no_pad_plain(x)
            bad = mismatches(got, want)
            worst["hash_no_pad_cuda"] = max(worst["hash_no_pad_cuda"], bad)
            err["hash_no_pad_cuda"] = max(err["hash_no_pad_cuda"], max_abs_err(got, want))
            log("kernels", kernel="hash_no_pad_cuda", plain="ops.poseidon.hash_no_pad",
                width=width, B=L, strided=strided, path=path, mismatches=bad)
    # the exact Python-int permutation on a few rows
    x = rand_field(rng, (4, 12), device)
    got = gl.to_u64(pc.permute_cuda(x))
    for row_in, row_out in zip(gl.to_u64(x), got):
        if [int(v) for v in row_out] != ps.permute_s([int(v) for v in row_in]):
            raise RuntimeError("permute_cuda disagrees with permute_s")
    zero = gl.to_u64(pc.permute_cuda(torch.zeros((1, 12), dtype=torch.int64, device=device)))[0]
    log("kernels", kernel="permute_cuda", against="permute_s", rows=4, ok=True,
        zero_digest=[int(v) for v in zero[:4]])
    torch.cuda.synchronize()
    if any(worst.values()) or any(err.values()):
        raise RuntimeError(f"kernel disagrees with its plain version: {worst} {err}")
    return err


def phase_timings(device, rng):
    """Each kernel's time at the shapes a 2^15-row proof gives it, beside
    its plain version's time and its bound."""
    from intmax_zkp_core_tpu_torch.ops import poseidon as ps
    from intmax_zkp_core_tpu_torch.ops import poseidon_cuda as pc

    B = 1 << 18
    flush = torch.empty(64 << 20, dtype=torch.int64, device=device)  # 512 MB
    out = {}
    x = rand_field(rng, (B, 12), device)
    out["permute_cuda"] = {
        "shape": [B, 12],
        "ms": time_ms(lambda: pc.permute_cuda(x), 10, flush),
        "plain_ms": time_ms(lambda: pc.permute_plain(x), 2, flush),
        **bound_ms(B, 12, 12, 1),
    }
    log("timing", kernel="permute_cuda", **out["permute_cuda"])
    # sponge widths of the proof's commitments; wide leaves arrive as the
    # transposed view of an [width, B] LDE, tree-level pairs contiguous
    for width, strided in ((135, True), (24, True), (16, True), (8, False)):
        x = rand_field(rng, (width, B) if strided else (B, width), device)
        x = x.t() if strided else x
        perms = (width + 7) // 8
        rec = {
            "shape": [B, width], "strided": strided,
            "ms": time_ms(lambda: pc.hash_no_pad_cuda(x), 5, flush),
            "chained_ms": time_ms(lambda: ps.hash_no_pad(x), 3, flush),
            "plain_ms": time_ms(lambda: pc.hash_no_pad_plain(x), 1, flush),
            **bound_ms(B, width, 4, perms),
        }
        out[f"hash_no_pad_cuda_w{width}"] = rec
        log("timing", kernel="hash_no_pad_cuda", **rec)
    del flush
    return out


NEW_KERNELS = ("perm_columns_cuda", "perm_quotient_cuda", "zinv_mul_cuda", "fri_initial_cuda")
CALLED_ONCE_PER_PROOF = NEW_KERNELS + ("poseidon_gate_quotient_cuda",)


def launches_per_proof() -> dict:
    """The launches one proof makes of each kernel of the permutation
    argument and of the Poseidon-gate kernel: one call each, K3's call in
    ``LAUNCHES_PER_CALL`` launches."""
    from intmax_zkp_core_tpu_torch.ops import perm_columns_cuda as pcol

    want = dict.fromkeys(CALLED_ONCE_PER_PROOF, 1)
    want["perm_columns_cuda"] = pcol.LAUNCHES_PER_CALL
    return want


def perm_columns_inputs(rng, device, K, C, R, n, extra_rows=0):
    return [rand_field(rng, (K, R + extra_rows, n), device), rand_field(rng, (K, C), device),
            rand_field(rng, (K, C), device), rand_field(rng, (R, n), device),
            rand_field(rng, (R, n), device)]


def perm_columns_edge_inputs(rng, device, K, C, R, n):
    """K3's wires, id and sigma on edge lanes (``edge_field``; betas and
    gammas random and not 0), with one g-factor of challenge 0 of proof 0 set
    to 0 at a few points, so that its g total is 0 there and only there;
    returns the inputs and those points."""
    from intmax_zkp_core_tpu_torch.ops import goldilocks as gl

    nonzero = lambda: gl.from_u64(rng.integers(1, P, size=(K, C), dtype=np.uint64), device)  # noqa: E731
    args = [edge_field(rng, (K, R, n), device), nonzero(), nonzero(),
            edge_field(rng, (R, n), device), edge_field(rng, (R, n), device)]
    wires, betas, gammas, sigma = (gl.to_u64(a.cpu()) for a in (args[0], args[1], args[2], args[4]))
    beta, gamma = int(betas[0, 0]), int(gammas[0, 0])
    zero_at = [7, n // 2, n - 1]
    for t in zero_at:
        wires[0, R - 1, t] = (-(beta * int(sigma[R - 1, t]) + gamma)) % P
    args[0] = gl.from_u64(wires, device)
    return args, zero_at


def perm_quotient_inputs(rng, device, K, C, R, L, extra_rows=0, edge=False):
    nch = (R + 6) // 7
    field = (lambda shape: edge_field(rng, shape, device)) if edge else (  # noqa: E731
        lambda shape: rand_field(rng, shape, device))
    return [field((K, R + extra_rows, L)), field((K, C, L)), field((K, C, nch - 1, L)),
            field((K, C)), field((K, C)), field((K, C)), field((R, L)), field((L,)),
            field((L,)), field((R,))]


def fri_initial_inputs(rng, device, K, L):
    return [rand_field(rng, (K, L, 2), device), rand_field(rng, (K, L, 2), device),
            rand_field(rng, (L,), device)] + [rand_field(rng, (K, 2), device) for _ in range(4)]


def phase_perm_kernels(device, rng, paths):
    """The four kernels of the permutation argument against their plain
    versions on the card, from 8 points up to each main path's sizes
    (``paths``: name -> log2 rows; n = 2^log_rows, L = 8 n), at a size that
    no block size divides, and over a leading axis of 1 and 3."""
    from intmax_zkp_core_tpu_torch.ops import fri_init_cuda as fi
    from intmax_zkp_core_tpu_torch.ops import goldilocks as gl
    from intmax_zkp_core_tpu_torch.ops import perm_columns_cuda as pcol
    from intmax_zkp_core_tpu_torch.ops import perm_quotient_cuda as pq
    from intmax_zkp_core_tpu_torch.ops import zinv_mul_cuda as zm

    odd, blowup, C = (1 << 12) + 8, 8, 2
    big = (1 << 20) + 8
    L_sizes = [(8, None), (odd, None)] + path_sizes(paths, 3)
    worst = dict.fromkeys(NEW_KERNELS, 0)
    err = dict.fromkeys(NEW_KERNELS, 0.0)

    def hold(kernel, got, want, **fields):
        bad = sum(mismatches(g, w) for g, w in zip(got, want))
        if not all(all_canonical(g) for g in got):
            raise RuntimeError(f"{kernel} wrote a lane not below p: {fields}")
        worst[kernel] = max(worst[kernel], bad)
        err[kernel] = max([err[kernel]] + [max_abs_err(g, w) for g, w in zip(got, want) if g.numel()])
        log("kernels", kernel=kernel, **fields, mismatches=bad)

    # the batch inverse of the device header (batch_inv_loose) through the
    # smallest kernel: 0, 1, p-1 and random lanes against the plain
    # square-and-multiply and exact integers
    z_h = rand_field(rng, (odd,), device)
    z_h[:3] = gl.from_u64(np.array([0, 1, P - 1], dtype=np.uint64), device)
    got = zm.zinv_mul_cuda(torch.ones_like(z_h), z_h)
    hold("zinv_mul_cuda", [got], [gl.inv(z_h)], plain="ops.goldilocks.inv", L=odd)
    for x, y in zip(gl.to_u64(z_h[:64]), gl.to_u64(got[:64])):
        if int(y) != pow(int(x), P - 2, P):
            raise RuntimeError(f"the inverse of {int(x)} is {int(y)} on the card")
    log("kernels", kernel="zinv_mul_cuda", against="pow(x, p-2, p)", lanes=64, ok=True,
        inv_of_0_1_pm1=[int(v) for v in gl.to_u64(got[:3])])

    for L, path in L_sizes:
        for lead in ((), (1,), (2,), (4,)):
            acc, z_h = rand_field(rng, lead + (L,), device), rand_field(rng, (L,), device)
            hold("zinv_mul_cuda", [zm.zinv_mul_cuda(acc, z_h)], [zm.zinv_mul_plain(acc, z_h)],
                 plain="zinv_mul_plain", rows=list(lead), L=L, **path_tag(path))
        for K in (1, 3):
            args = fri_initial_inputs(rng, device, K, L)
            hold("fri_initial_cuda", [fi.fri_initial_cuda(*args)], [fi.fri_initial_plain(*args)],
                 plain="fri_initial_plain", K=K, L=L, **path_tag(path))

    # edge lanes, and zeros planted in one thread's points (``batch_points``):
    # K6 z_h 0 at its first, a middle and its last point, over all the points
    # of another thread and of a whole block; K7 proof k's zeta in the base
    # field on the point at the first (k = 0), a middle (1) or the last (2)
    # place of one thread's, its g*zeta likewise in another thread's, so that
    # only that term is zero there
    for L, path in L_sizes[1:]:
        batch = batch_points(zm.batch_layout(), L)
        span = zm.batch_layout()[0] * zm.batch_layout()[1]
        for lead in ((), (1,), (2,), (4,)):
            acc, z_h = edge_field(rng, lead + (L,), device), edge_field(rng, (L,), device)
            z_h[[batch[0], batch[len(batch) // 2], batch[-1]]] = 0
            z_h[[t + 2 for t in batch]] = 0
            z_h[2 * span : 3 * span] = 0
            got = zm.zinv_mul_cuda(acc, z_h)
            hold("zinv_mul_cuda", [got], [zm.zinv_mul_plain(acc, z_h)], plain="zinv_mul_plain",
                 rows=list(lead), L=L, inputs="edge lanes, planted zeros", thread_zeros_at=batch,
                 block_zeros_from=2 * span, to=3 * span, **path_tag(path))
            if not torch.equal(got != 0, (acc != 0) & (z_h != 0)):
                raise RuntimeError("zinv_mul_cuda: a zero of z_h reached another lane")
        batch = batch_points(fi.batch_layout(), L)
        xs = gl.from_u64(rng.integers(0, P, size=L, dtype=np.uint64), device)  # distinct points
        args = [edge_field(rng, (3, L, 2), device), edge_field(rng, (3, L, 2), device), xs]
        args += [edge_field(rng, (3, 2), device) for _ in range(4)]
        zeros = []
        for k, i in enumerate((0, len(batch) // 2, len(batch) - 1)):
            args[3][k] = torch.stack([xs[batch[i]], xs.new_zeros(())])
            args[4][k] = torch.stack([xs[batch[i] + 1], xs.new_zeros(())])
            zeros += [batch[i], batch[i] + 1]
        hold("fri_initial_cuda", [fi.fri_initial_cuda(*args)], [fi.fri_initial_plain(*args)],
             plain="fri_initial_plain", K=3, L=L, inputs="edge lanes, planted zero norms",
             zero_norms_at=zeros, **path_tag(path))

    # K3, the whole function, at every size; at 2^20 + 8 points pass B
    # carries between more block totals than one of its scan steps holds;
    # then C = 1, 3, 4 and 5 and edge lanes with a zero g total.  K5 at every R
    # up to the odd size and, at each main path's L, at the main paths' R only
    # (its plain version takes seconds there), then C = 1 - 4 on edge lanes
    # and C = 5.  K5 itself takes any L: the shift by `blowup` wraps modulo L.
    for n, path in [(8, None), (odd, None)] + path_sizes(paths) + [(big, None)]:
        for R in (3, 7, 8, 23, 80) if n != big else (80,):
            for K in (1, 3) if n != big else (1,):
                args = perm_columns_inputs(rng, device, K, C, R, n, extra_rows=K - 1)
                hold("perm_columns_cuda", pcol.perm_columns_cuda(*args),
                     pcol.perm_columns_plain(*args), plain="perm_columns_plain", K=K, C=C, R=R, n=n,
                     **path_tag(path))
                del args
    for C_ in (1, 3, 4, 5):
        args = perm_columns_inputs(rng, device, 2, C_, 23, odd, extra_rows=1)
        hold("perm_columns_cuda", pcol.perm_columns_cuda(*args), pcol.perm_columns_plain(*args),
             plain="perm_columns_plain", K=2, C=C_, R=23, n=odd)
    for R in (5, 80):
        args, zero_at = perm_columns_edge_inputs(rng, device, 2, C, R, odd)
        got = pcol.perm_columns_cuda(*args)
        hold("perm_columns_cuda", got, pcol.perm_columns_plain(*args),
             plain="perm_columns_plain", K=2, C=C, R=R, n=odd, inputs="edge lanes",
             zero_g_total_at=zero_at)
        z, first = got[0], zero_at[0]
        if not (bool((z[0, 0, first + 1 :] == 0).all()) and bool((z[0, 0, : first + 1] != 0).all())
                and bool((z[0, 1] != 0).all())):
            raise RuntimeError("a zero g total did not zero Z from the next point on, alone")
    for L, path in L_sizes:
        for R in (80,) if path else (3, 7, 8, 23, 80):
            for K in (1, 3):
                # at a main path's shape the wire matrix carries all 135 rows
                extra = 55 if (path and K == 1) else K - 1
                args = perm_quotient_inputs(rng, device, K, C, R, L, extra_rows=extra)
                hold("perm_quotient_cuda", pq.perm_quotient_cuda(*args, blowup),
                     pq.perm_quotient_plain(*args, blowup),
                     plain="perm_quotient_plain", K=K, R=R, L=L, wire_rows=R + extra,
                     **path_tag(path))
                del args
    for C_, edge in ((1, True), (2, True), (3, True), (4, True), (5, False)):
        args = perm_quotient_inputs(rng, device, 2, C_, 80, odd, extra_rows=2, edge=edge)
        hold("perm_quotient_cuda", pq.perm_quotient_cuda(*args, blowup),
             pq.perm_quotient_plain(*args, blowup), plain="perm_quotient_plain", K=2, C=C_, R=80,
             L=odd, inputs="edge lanes" if edge else "random")
        del args
    torch.cuda.synchronize()
    if any(worst.values()) or any(err.values()):
        raise RuntimeError(f"kernel disagrees with its plain version: {worst} {err}")
    return err


def phase_perm_timings(device, rng, log_rows):
    """Each kernel of the permutation argument at the shape a proof of
    2^log_rows rows gives it, beside its plain version's time and its bound."""
    from intmax_zkp_core_tpu_torch.ops import fri_init_cuda as fi
    from intmax_zkp_core_tpu_torch.ops import goldilocks as gl
    from intmax_zkp_core_tpu_torch.ops import perm_columns_cuda as pcol
    from intmax_zkp_core_tpu_torch.ops import perm_quotient_cuda as pq
    from intmax_zkp_core_tpu_torch.ops import zinv_mul_cuda as zm

    n, L, R, C, blowup = 1 << log_rows, 1 << (log_rows + 3), 80, 2, 8
    flush = torch.empty(64 << 20, dtype=torch.int64, device=device)  # 512 MB
    out = {}

    def record(name, shape, kernel, plain, bound_fields):
        out[name] = {"shape": shape, "ms": time_ms(kernel, 10, flush),
                     "plain_ms": time_ms(plain, 2, flush), **bound_fields}
        log("timing", kernel=name, **out[name])

    args = perm_columns_inputs(rng, device, 1, C, R, n)
    record("perm_columns_cuda", [1, R, n], lambda: pcol.perm_columns_cuda(*args),
           lambda: pcol.perm_columns_plain(*args), perm_columns_bound(1, C, R, n))

    args = perm_quotient_inputs(rng, device, 1, C, R, L, extra_rows=55)  # all 135 wire rows
    record("perm_quotient_cuda", [1, C, L], lambda: pq.perm_quotient_cuda(*args, blowup),
           lambda: pq.perm_quotient_plain(*args, blowup), perm_quotient_bound(1, C, R, L))
    del args

    # Z_H as the prover has it: `blowup` distinct values, repeated along the coset
    acc = rand_field(rng, (C, L), device)
    z_h = gl.sub(rand_field(rng, (blowup,), device), 1).repeat(L // blowup)
    distinct = int(torch.unique(z_h).numel())
    record("zinv_mul_cuda", [C, L], lambda: zm.zinv_mul_cuda(acc, z_h),
           lambda: zm.zinv_mul_plain(acc, z_h),
           zinv_mul_bound(C, L, distinct, zm.batch_layout()))

    args = fri_initial_inputs(rng, device, 1, L)
    record("fri_initial_cuda", [1, L, 2], lambda: fi.fri_initial_cuda(*args),
           lambda: fi.fri_initial_plain(*args), fri_initial_bound(1, L, fi.batch_layout()))
    del flush
    return out


def gate_quotient_inputs(rng, device, K, C, L, extra_rows=0):
    return [rand_field(rng, (K, 135 + extra_rows, L), device), rand_field(rng, (L,), device),
            rand_field(rng, (K, C), device), rand_field(rng, (K, C, L), device),
            rand_field(rng, (K, C), device)]


EDGE_LANES = (0, 1, (1 << 32) - 1, 1 << 32, 1 << 63, P - 1)


def edge_field(rng, shape, device) -> torch.Tensor:
    """Canonical field elements whose first lanes, and a run in every 97 *
    6, hold 0, 1, 2^32 - 1, 2^32, 2^63 and p - 1 in turn."""
    from intmax_zkp_core_tpu_torch.ops import goldilocks as gl

    a = rng.integers(0, P, size=shape, dtype=np.uint64)
    flat = a.reshape(-1)
    for i, v in enumerate(EDGE_LANES):
        flat[i :: 97 * len(EDGE_LANES)] = v
        flat[i * 97 + 1 :: 97 * len(EDGE_LANES)] = v
    return gl.from_u64(a, device)


def batch_points(layout: tuple, L: int) -> list:
    """The points of one thread in a kernel of ``layout`` (threads a block,
    points a thread, which lie a block width apart): thread 1 of block 1.
    ``L`` must hold three blocks."""
    threads, points = layout
    first = threads * points + 1
    if 3 * threads * points > L:
        raise ValueError(f"{L} points hold no three blocks of {layout}")
    return [first + i * threads for i in range(points)]


def all_canonical(x: torch.Tensor) -> bool:
    """Every lane of an int64 bit-pattern tensor below p: as signed int64,
    u < 2^63 is u >= 0 and p <= u < 2^64 is -2^32 < x < 0."""
    return bool(((x >= 0) | (x <= -(1 << 32))).all().item())


def ntt_chain_shapes(log_rows):
    """The NTTs of one proof of 2^log_rows rows at the standard recursion
    config, by name: (rows, length, inverse) - the wires' intt and coset LDE's
    ntt, the Z / partial products' (2 challenges x 12 chunks), the
    quotient's intt of its 2 challenges and the ntt of its 16 chunks."""
    n, L = 1 << log_rows, 1 << (log_rows + 3)
    return {"ntt_cuda_intt_wires": (135, n, True), "ntt_cuda": (135, L, False),
            "ntt_cuda_intt_zs": (24, n, True), "ntt_cuda_zs": (24, L, False),
            "ntt_cuda_intt_quotient": (2, L, True), "ntt_cuda_quotient": (16, L, False)}


def phase_gate_ntt_kernels(device, rng, paths):
    """K4 and K2 against their plain versions on the card.  K4 at K in {1, 3},
    C = 2, 64 / 2^14 / each main path's (``paths``: name -> log2 rows) LDE
    points, the wire matrix with its 135 rows at K = 1 and with two more at
    K = 3; K2 at every length 2^0 .. 2^22 at B = 1 and at every (B, length)
    of each main path's proof (``ntt_chain_shapes``), both directions, and the
    round trip through the public entry points.  Then both on edge-lane
    inputs (0, 1, 2^32 - 1, 2^32, 2^63, p - 1): K4 at C = 1 .. 4 over a
    number of points no block divides, K2 at every shape of each main path's
    proof; every output lane must be below p."""
    from intmax_zkp_core_tpu_torch.ops import gate_quotient_cuda as gqc
    from intmax_zkp_core_tpu_torch.ops import ntt as nt
    from intmax_zkp_core_tpu_torch.ops import ntt_cuda as nc

    names = ("poseidon_gate_quotient_cuda", "ntt_cuda")
    worst, err = dict.fromkeys(names, 0), dict.fromkeys(names, 0.0)

    def hold(kernel, got, want, **fields):
        bad = sum(mismatches(g, w) for g, w in zip(got, want))
        if not all(all_canonical(g) for g in got):
            raise RuntimeError(f"{kernel} wrote a lane not below p: {fields}")
        worst[kernel] = max(worst[kernel], bad)
        err[kernel] = max([err[kernel]] + [max_abs_err(g, w) for g, w in zip(got, want)])
        log("kernels", kernel=kernel, **fields, mismatches=bad)

    C = 2
    for L, path in [(64, None), (1 << 14, None)] + path_sizes(paths, 3):
        for K in (1, 3):
            args = gate_quotient_inputs(rng, device, K, C, L, extra_rows=0 if K == 1 else 2)
            hold("poseidon_gate_quotient_cuda", gqc.poseidon_gate_quotient_cuda(*args),
                 gqc.poseidon_gate_quotient_plain(*args), plain="poseidon_gate_quotient_plain",
                 K=K, C=C, L=L, wire_rows=args[0].shape[1], **path_tag(path))
            del args
    for C in (1, 2, 3, 4):
        L = (1 << 14) + 100
        args = [edge_field(rng, (2, 135, L), device), edge_field(rng, (L,), device),
                edge_field(rng, (2, C), device), edge_field(rng, (2, C, L), device),
                edge_field(rng, (2, C), device)]
        hold("poseidon_gate_quotient_cuda", gqc.poseidon_gate_quotient_cuda(*args),
             gqc.poseidon_gate_quotient_plain(*args), plain="poseidon_gate_quotient_plain",
             K=2, C=C, L=L, inputs="edge lanes")
        del args
    # K2's layout depends on the batch as well as the length (``group_log``),
    # so every (B, length) of each path is held in both directions
    shapes = [(1, 1 << log_n, None) for log_n in range(nc.MAX_LOG_N + 1)]
    for path, log_rows in paths.items():
        shapes += [(B, n, path) for B, n in dict.fromkeys(
            (B, n) for B, n, _ in ntt_chain_shapes(log_rows).values())]
    round_trip = {1 << k for k in (1, 11, 12, nc.MAX_LOG_N)}
    round_trip |= {1 << (k + d) for k in paths.values() for d in (0, 3)}
    for B, n, path in shapes:
        x = rand_field(rng, (B, n), device)
        for inverse in (False, True):
            hold("ntt_cuda", [nc.ntt_cuda(x, inverse)], [nc.ntt_plain(x, inverse)],
                 plain="ops.ntt._ntt_impl", B=B, n=n, inverse=inverse, **path_tag(path))
        if n in round_trip:
            back = nt.intt(nt.ntt(x))
            hold("ntt_cuda", [back], [x], against="intt(ntt(x)) == x", B=B, n=n,
                 **path_tag(path))
        del x
    for path, log_rows in paths.items():
        for name, (B, n, inverse) in ntt_chain_shapes(log_rows).items():
            x = edge_field(rng, (B, n), device)
            hold("ntt_cuda", [nc.ntt_cuda(x, inverse)], [nc.ntt_plain(x, inverse)],
                 plain="ops.ntt._ntt_impl", B=B, n=n, inverse=inverse, inputs="edge lanes",
                 path=path)
            del x
    try:
        nc.ntt_cuda(torch.zeros((1, 2 << nc.MAX_LOG_N), dtype=torch.int64, device=device))
    except ValueError:
        log("kernels", kernel="ntt_cuda", n=2 << nc.MAX_LOG_N, above_the_limit="raises")
    else:
        raise RuntimeError("ntt_cuda took a length above its stated limit")
    torch.cuda.synchronize()
    if any(worst.values()) or any(err.values()):
        raise RuntimeError(f"kernel disagrees with its plain version: {worst} {err}")
    return err


def phase_gate_ntt_timings(device, rng, log_rows):
    """K4 and K2 at the shapes a proof of 2^log_rows rows gives them: K4 over
    the 135 wire rows of the LDE with C = 2, K2 at each of the proof's NTT
    shapes (``ntt_chain_shapes``).  The plain versions are timed once or
    twice (the plain K4 at 2^18 points is some hundreds of launches)."""
    from intmax_zkp_core_tpu_torch.ops import gate_quotient_cuda as gqc
    from intmax_zkp_core_tpu_torch.ops import ntt_cuda as nc

    L, C = 1 << (log_rows + 3), 2
    flush = torch.empty(64 << 20, dtype=torch.int64, device=device)  # 512 MB
    out = {}
    args = gate_quotient_inputs(rng, device, 1, C, L)
    out["poseidon_gate_quotient_cuda"] = {
        "shape": [1, 135, L], "C": C,
        "ms": time_ms(lambda: gqc.poseidon_gate_quotient_cuda(*args), 10, flush),
        "plain_ms": time_ms(lambda: gqc.poseidon_gate_quotient_plain(*args), 1, flush),
        **gate_quotient_bound(1, C, L)}
    log("timing", kernel="poseidon_gate_quotient_cuda", **out["poseidon_gate_quotient_cuda"])
    del args
    for name, (rows, length, inverse) in ntt_chain_shapes(log_rows).items():
        x = rand_field(rng, (rows, length), device)
        out[name] = {
            "shape": [rows, length], "inverse": inverse, "launches_per_call": nc.launches_for(length),
            "ms": time_ms(lambda: nc.ntt_cuda(x, inverse), 10, flush),
            "plain_ms": time_ms(lambda: nc.ntt_plain(x, inverse), 2, flush),
            **ntt_bound(rows, length, inverse)}
        log("timing", kernel="ntt_cuda", name=name, **out[name])
        del x
    del flush
    return out


def ntt_launches_per_proof(common) -> int:
    """``ntt_cuda`` launches of one proof, or of one batch of proofs (the
    proof axis folds into the rows of each call), by its call sites: the
    intt and the coset LDE's ntt of the wires' and of the Z / partial-product
    commitments, the intt of quotient_finish and the ntt of the quotient
    commitment (at the LDE size), and the one coset_ilde of the FRI final
    polynomials' two components."""
    from intmax_zkp_core_tpu_torch.ops import ntt_cuda as nc

    fri = common.config.fri
    n, lde_n = common.n, common.n * fri.blowup
    final_n = min(lde_n, fri.final_poly_len * fri.blowup)
    return 2 * nc.launches_for(n) + 4 * nc.launches_for(lde_n) + nc.launches_for(final_n)


def expect_ntt_launches(before: dict, after: dict, common, what: str) -> int:
    got = after["ntt_cuda"] - before["ntt_cuda"]
    want = ntt_launches_per_proof(common)
    if got != want:
        raise RuntimeError(f"the {what} proof launched ntt_cuda {got} times, not {want}")
    return got


def phase_zkdsa(device, golden_path):
    from intmax_zkp_core_tpu_torch.engine.config import CircuitConfig
    from intmax_zkp_core_tpu_torch.models.zkdsa import make_simple_signature_circuit
    from intmax_zkp_core_tpu_torch.utils.hash_out import HashOut

    from intmax_zkp_core_tpu_torch.ops import poseidon_cuda as pc

    c0 = pc.launch_counts()
    t0 = time.perf_counter()
    circuit = make_simple_signature_circuit(CircuitConfig.standard_recursion_config())
    t1 = time.perf_counter()
    c1 = pc.launch_counts()
    proof = circuit.prove(HashOut.from_u64(42), HashOut.from_u64(0xABCDEF))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    c2 = pc.launch_counts()
    if c2["permute_cuda"] - c1["permute_cuda"] <= 0:
        raise RuntimeError("the zkDSA proof launched no permute_cuda kernel")
    expect_per_proof(c1, c2, "zkDSA")
    expect_ntt_launches(c1, c2, circuit.data.common, "zkDSA")
    circuit.verify(proof)
    t3 = time.perf_counter()
    expect_rejected(circuit, proof)
    digest = proof_sha256(proof)
    with open(golden_path) as f:
        golden = f.read().split()[0]
    if digest != golden:
        raise RuntimeError(f"zkDSA proof hash {digest} != golden {golden}")
    log("zkdsa", rows=circuit.data.common.n, build_s=round(t1 - t0, 3),
        prove_s=round(t2 - t1, 3), verify_s=round(t3 - t2, 3), tampered="rejected",
        sha256=digest, golden="equal",
        launches_build={k: c1[k] - c0[k] for k in c1 if c1[k] - c0[k]},
        launches_prove={k: c2[k] - c1[k] for k in c2 if c2[k] - c1[k]})


def expect_parts_add_up(timings: dict) -> None:
    """``quotient`` and ``fri`` come split into parts that sum to the phase."""
    for phase, parts in (
        ("quotient", ("quotient_perm", "quotient_gates", "quotient_finish", "quotient_commit")),
        ("fri", ("fri_combine", "fri_initial", "fri_fold", "fri_grind", "fri_queries")),
    ):
        if abs(sum(timings[p] for p in parts) - timings[phase]) > 1e-6:
            raise RuntimeError(f"the parts of {phase} do not add up: {timings}")


def phase_chain(device, log_rows):
    """Build the hash chain, prove it with the kernels in both wirings
    (chained permutation launches, then the fused sponge), verify; returns
    what the plain-path comparison needs."""
    from intmax_zkp_core_tpu_torch.engine.config import CircuitConfig
    from intmax_zkp_core_tpu_torch.models.hash_chain import (
        links_for_rows, make_hash_chain_circuit,
    )
    from intmax_zkp_core_tpu_torch.utils.hash_out import HashOut

    from intmax_zkp_core_tpu_torch.ops import poseidon_cuda as pc

    c0 = pc.launch_counts()
    t0 = time.perf_counter()
    circuit = make_hash_chain_circuit(
        links_for_rows(log_rows), CircuitConfig.standard_recursion_config()
    )
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    after_build = pc.launch_counts()
    n = circuit.data.common.n
    if n != 1 << log_rows:
        raise RuntimeError(f"hash chain has {n} rows, wanted 2^{log_rows}")
    seed, salt = HashOut.from_u64(7), HashOut.from_u64(0xC0FFEE)
    torch.cuda.reset_peak_memory_stats()
    timings = {}
    proof = circuit.prove(seed, salt, timings=timings)
    t2 = time.perf_counter()
    circuit.verify(proof)
    t3 = time.perf_counter()
    expect_rejected(circuit, proof)
    log("chain", rows=n, log_rows=log_rows, links=circuit.num_links,
        build_s=round(t1 - t0, 3), prove_s=round(t2 - t1, 3), verify_s=round(t3 - t2, 3),
        tampered="rejected",
        launches_build={k: after_build[k] - c0[k] for k in after_build if after_build[k] - c0[k]},
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
    log("chain-phases", **{k: round(v, 4) for k, v in timings.items()})
    expect_parts_add_up(timings)
    after_chained = pc.launch_counts()
    expect_per_proof(after_build, after_chained, "chain (chained wiring)")
    expect_ntt_launches(after_build, after_chained, circuit.data.common, "chain (chained wiring)")

    # the same proof through the fused-sponge wiring
    t0 = time.perf_counter()
    fused_timings = {}
    proof_fused = circuit.prove(seed, salt, fused_sponge=True, timings=fused_timings)
    t1 = time.perf_counter()
    after_fused = pc.launch_counts()
    expect_per_proof(after_chained, after_fused, "chain (fused wiring)")
    expect_ntt_launches(after_chained, after_fused, circuit.data.common, "chain (fused wiring)")
    log("chain-launches-per-proof",
        chained_wiring={k: after_chained[k] - after_build[k] for k in after_build},
        fused_wiring={k: after_fused[k] - after_chained[k] for k in after_build})
    caps = lambda p: [p.wires_cap, p.zs_pp_cap, p.quotient_cap, p.fri.caps]  # noqa: E731
    if caps(proof_fused) != caps(proof):
        raise RuntimeError("fused-sponge and chained wirings give different caps")
    if proof_sha256(proof_fused) != proof_sha256(proof):
        raise RuntimeError("fused-sponge and chained wirings give different proofs")
    log("chain-fused", prove_s=round(t1 - t0, 3), caps="equal", proof="equal",
        **{k: round(v, 4) for k, v in fused_timings.items()})
    return (circuit, seed, salt, proof), (timings, fused_timings)


def phase_chain_plain(circuit, seed, salt, proof):
    """The chain once more with the plain versions on the card: the proof
    must equal the kernel path's, and no kernel may be launched."""
    timings = {}
    seconds = plain_path_proof(lambda: circuit.prove(seed, salt, timings=timings), proof)
    log("chain-plain", prove_s=round(seconds, 3), proof="equal", kernels_launched=0,
        **{k: round(v, 4) for k, v in timings.items()})


def plain_path_proof(prove, proof) -> float:
    """``prove()`` with the plain versions on the card, which must give
    ``proof`` and launch no kernel; returns its seconds.  This holds every
    kernel against its plain version at every shape and on every input the
    proof gives it.

    The port has no switch that sends a tensor on the card to a plain
    version, so for this one comparison every kernel wrapper is replaced by
    its plain version here and put back afterwards."""
    from intmax_zkp_core_tpu_torch.ops import fri_init_cuda as fi
    from intmax_zkp_core_tpu_torch.ops import gate_quotient_cuda as gqc
    from intmax_zkp_core_tpu_torch.ops import ntt_cuda as nc
    from intmax_zkp_core_tpu_torch.ops import perm_columns_cuda as pcol
    from intmax_zkp_core_tpu_torch.ops import perm_quotient_cuda as pq
    from intmax_zkp_core_tpu_torch.ops import poseidon_cuda as pc
    from intmax_zkp_core_tpu_torch.ops import zinv_mul_cuda as zm

    swaps = (
        (pc, "permute_cuda", pc.permute_plain),
        (pc, "hash_no_pad_cuda", pc.hash_no_pad_plain),
        (pcol, "perm_columns_cuda", pcol.perm_columns_plain),
        (pq, "perm_quotient_cuda", pq.perm_quotient_plain),
        (zm, "zinv_mul_cuda", zm.zinv_mul_plain),
        (fi, "fri_initial_cuda", fi.fri_initial_plain),
        (gqc, "poseidon_gate_quotient_cuda", gqc.poseidon_gate_quotient_plain),
        (nc, "ntt_cuda", nc.ntt_plain),
    )
    before = pc.launch_counts()
    t0 = time.perf_counter()
    wrappers = [(module, name, getattr(module, name)) for module, name, _ in swaps]
    try:
        for module, name, plain in swaps:
            setattr(module, name, plain)
        proof_plain = prove()
        torch.cuda.synchronize()
    finally:
        for module, name, wrapper in wrappers:
            setattr(module, name, wrapper)
    seconds = time.perf_counter() - t0
    if pc.launch_counts() != before:
        raise RuntimeError("the plain-path proof launched a kernel")
    if proof_sha256(proof_plain) != proof_sha256(proof):
        raise RuntimeError("kernel-path and plain-path proofs differ")
    return seconds


def phase_native(rng) -> None:
    """Build the host C++ with g++ and hold the native permutation and
    sponge against ``permute_s`` and the sponge's Python body: seeded states,
    every lane on each edge value, and inputs of every width 0 - 25."""
    from intmax_zkp_core_tpu_torch.native import loader
    from intmax_zkp_core_tpu_torch.ops import poseidon as ps

    gxx = subprocess.run([loader.CXX, "--version"], capture_output=True, text=True, timeout=60)
    loader.load("poseidon")
    loader.load("witness")

    def rows(n, width):
        out = [[int(v) for v in r] for r in rng.integers(0, P, size=(n, width), dtype=np.uint64)]
        out += [[v] * width for v in EDGE_LANES]
        out.append([EDGE_LANES[i % len(EDGE_LANES)] for i in range(width)])
        return out

    states = rows(256, 12)
    bad_perm = sum(
        [int(v) for v in got] != ps.permute_s(state)
        for state, got in zip(states, loader.native_permute_batch(states)))
    bad_perm += sum(ps.permute_host(state) != ps.permute_s(state) for state in states[:16])
    bad_sponge, n_sponge = 0, 0
    for width in range(26):
        for row in rows(16, width):
            bad_sponge += ps.hash_n_to_m_no_pad_s(row) != ps.hash_n_to_m_no_pad_plain_s(row, 4)
            n_sponge += 1
    log("native", gxx="'" + gxx.stdout.splitlines()[0] + "'",
        flags="'" + " ".join(loader.CXX_FLAGS) + "'",
        build_s={k: round(v, 2) for k, v in loader.BUILD_SECONDS.items()},
        permutations=len(states) + 16, permutation_mismatches=bad_perm,
        sponges=n_sponge, widths="0-25", sponge_mismatches=bad_sponge, edge_lanes=list(EDGE_LANES))
    if bad_perm or bad_sponge:
        raise RuntimeError("the native Poseidon disagrees with the Python one")


def phase_chain_witness(circuit, seed, salt, timings: dict, fused_timings: dict) -> None:
    """The chain's witness: the first proof's (the fill plan built in it) and
    the second's, the plan and the native fill timed apart, and once the
    Python ``WitnessFill``, whose wire matrix and public inputs must equal
    the native fill's."""
    from intmax_zkp_core_tpu_torch.engine.prover import compute_wire_matrix, compute_wire_matrix_plain
    from intmax_zkp_core_tpu_torch.native.witness import FillPlan

    pd, pw = circuit.data.prover, circuit.witness(seed, salt)
    t0 = time.perf_counter()
    FillPlan(pd)  # a fresh plan, as the first proof built it
    t1 = time.perf_counter()
    wires, pi = compute_wire_matrix(pd, pw)
    t2 = time.perf_counter()
    wires_py, pi_py = compute_wire_matrix_plain(pd, pw)
    t3 = time.perf_counter()
    if not (wires == wires_py).all() or pi != pi_py:
        raise RuntimeError("the native and the Python witness fills differ")
    log("chain-witness", first_proof_witness_s=round(timings["witness"], 4),
        second_proof_witness_s=round(fused_timings["witness"], 4), plan_s=round(t1 - t0, 4),
        native_fill_s=round(t2 - t1, 4), python_fill_s=round(t3 - t2, 4),
        wires="equal", public_inputs="equal", records=len(pd.generators))


SMT_LEVELS, SMT_STEPS, SMT_SEED = 256, 5, 1
SMT_LOG_ROWS = 12  # log2 rows of the process circuit at SMT_LEVELS, standard config


def phase_smt(golden_path) -> list:
    """The SMT process-proof loop of ``bin/verify_smt_process.py`` on the
    card: build the circuit at n_levels=256 and standard_recursion_config,
    then prove and verify each of five seeded steps (insert into the empty
    tree, insert beside a leaf, update, remove, no-op).  The circuit's digest
    and the first proof's hash must equal the JAX-made golden's, a tampered
    proof must be rejected,
    and the first step proved again in the fused-sponge wiring must give the
    same proof.  Returns the launches of each proof."""
    from intmax_zkp_core_tpu_torch.bin import verify_smt_process as vsp
    from intmax_zkp_core_tpu_torch.models.sparse_merkle_tree import SparseMerkleTree
    from intmax_zkp_core_tpu_torch.ops import poseidon_cuda as pc

    with open(golden_path) as f:
        golden, digest_line = f.read().splitlines()[:2]
    golden = golden.split()[0]
    golden_digest = tuple(int(x) for x in digest_line.split()[1:5])
    t0 = time.perf_counter()
    data, target = vsp.build_circuit(SMT_LEVELS)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if tuple(data.common.circuit_digest) != golden_digest:
        raise RuntimeError("the SMT circuit's digest differs from the JAX package's")
    if data.common.n != 1 << SMT_LOG_ROWS:  # the rows its kernels were held at
        raise RuntimeError(f"the SMT circuit has {data.common.n} rows, not 2^{SMT_LOG_ROWS}")
    log("smt", n_levels=SMT_LEVELS, rows=data.common.n, records=len(data.prover.generators),
        circuit_digest="equal", build_s=round(build_s, 3), launches_build={k: n for k, n in pc.launch_counts().items() if n})
    tree = SparseMerkleTree()
    per_proof, first = [], None
    for i, (key, value) in enumerate(vsp.role_cycle(SMT_STEPS, SMT_LEVELS, SMT_SEED)):
        process_proof, pw = vsp.step(tree, target, key, value)
        before, timings = pc.launch_counts(), {}
        t0 = time.perf_counter()
        proof = data.prove(pw, timings=timings)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        after = pc.launch_counts()
        data.verify(proof)
        t2 = time.perf_counter()
        expect_per_proof(before, after, "SMT")
        expect_ntt_launches(before, after, data.common, "SMT")
        if proof.public_inputs != list(process_proof.old_root) + list(process_proof.new_root):
            raise RuntimeError("the SMT proof's public inputs are not the old and new roots")
        launches = {k: after[k] - before[k] for k in after if after[k] - before[k]}
        per_proof.append(launches)
        log("smt-proof", step=i, role=process_proof.fnc.name, witness_s=round(timings["witness"], 4),
            prove_s=round(t1 - t0, 3), verify_s=round(t2 - t1, 3), launches=launches,
            **{k: round(v, 4) for k, v in timings.items() if k != "witness"})
        if i == 0:
            first = (pw, proof)
    pw, proof = first
    expect_rejected(data, proof)
    digest = proof_sha256(proof)
    if digest != golden:
        raise RuntimeError(f"SMT proof hash {digest} != golden {golden}")
    before = pc.launch_counts()
    fused = data.prove(pw, fused_sponge=True)
    fused_launches = {k: n - before[k] for k, n in pc.launch_counts().items() if n - before[k]}
    if proof_sha256(fused) != digest:
        raise RuntimeError("the SMT proof differs between the sponge wirings")
    log("smt-done", proofs=len(per_proof), verified=True, tampered="rejected", sha256=digest,
        golden="equal", fused_wiring="equal", fused_launches=fused_launches)
    return per_proof


USER_TX_LOG_ROWS, USER_TX_K = 12, 3  # the flagship's user-tx circuit (4,096 rows) and its batch


def ntt_batch_shapes(log_rows, K):
    """The NTTs of one batch of K proofs of 2^log_rows rows at the standard
    recursion config: each of ``ntt_chain_shapes`` over K times the rows (the
    proof axis folds into the rows of each call), and the one coset_ilde of
    the FRI final polynomials' two components, [2K, 32 * 8]."""
    shapes = {name: (K * B, n, inverse)
              for name, (B, n, inverse) in ntt_chain_shapes(log_rows).items()}
    shapes["ntt_cuda_final_poly"] = (2 * K, 32 * 8, True)
    return shapes


def phase_user_tx_kernels(device, rng, log_rows, K, path="user_tx"):
    """Every kernel against its plain version at the shapes the K-proof
    user-tx batch gives it (n = 2^log_rows, L = 8 n, 135 wires, R = 80,
    C = 2), each line tagged ``path=`` ``path`` (the block path calls it at
    its own height and K = 1): K1 on the chained sponge's
    states of K trees' leaves [K, L, 12] and first level [K, L/2, 12]; K1b on
    the leaves of K trees as the fused wiring hands them over (the transposed
    [K, w, L] LDE copied to [K L, w], w = 135, 24, 16) and on the level pairs
    [K L/2, 8]; K3 on the [K, 135, n] wire matrix, and on edge lanes with a
    zero g total; K5 over the [K, 135, L] LDE, K4 on [K, 135, L], both on
    random and edge lanes; K6 on the [K C, L] numerators (and as [K, C, L])
    with planted zeros; K7 on [K, L, 2], random and with planted zero norms;
    K2 at every (rows, length) of the batch proof (``ntt_batch_shapes``), both
    directions, random and edge lanes, with round trips.  Every output lane
    of K2 - K7 must be below p."""
    from intmax_zkp_core_tpu_torch.ops import fri_init_cuda as fi
    from intmax_zkp_core_tpu_torch.ops import gate_quotient_cuda as gqc
    from intmax_zkp_core_tpu_torch.ops import goldilocks as gl
    from intmax_zkp_core_tpu_torch.ops import ntt as nt
    from intmax_zkp_core_tpu_torch.ops import ntt_cuda as nc
    from intmax_zkp_core_tpu_torch.ops import perm_columns_cuda as pcol
    from intmax_zkp_core_tpu_torch.ops import perm_quotient_cuda as pq
    from intmax_zkp_core_tpu_torch.ops import poseidon_cuda as pc
    from intmax_zkp_core_tpu_torch.ops import zinv_mul_cuda as zm

    n, L, R, C, W, blowup = 1 << log_rows, 1 << (log_rows + 3), 80, 2, 135, 8
    names = ("permute_cuda", "hash_no_pad_cuda") + CALLED_ONCE_PER_PROOF + ("ntt_cuda",)
    worst, err = dict.fromkeys(names, 0), dict.fromkeys(names, 0.0)

    def hold(kernel, got, want, canonical=True, **fields):
        bad = sum(mismatches(g, w) for g, w in zip(got, want))
        if canonical and not all(all_canonical(g) for g in got):
            raise RuntimeError(f"{kernel} wrote a lane not below p: {fields}")
        worst[kernel] = max(worst[kernel], bad)
        err[kernel] = max([err[kernel]] + [max_abs_err(g, w) for g, w in zip(got, want)])
        log("kernels", kernel=kernel, **fields, path=path, mismatches=bad)

    for shape in ((K, L, 12), (K, L // 2, 12)):
        x = rand_field(rng, shape, device)
        hold("permute_cuda", [pc.permute_cuda(x)], [pc.permute_plain(x)], canonical=False,
             plain="ops.poseidon.permute", shape=list(shape))
    for width in (135, 24, 16):
        x = rand_field(rng, (K, width, L), device).transpose(1, 2).reshape(K * L, width)
        hold("hash_no_pad_cuda", [pc.hash_no_pad_cuda(x)], [pc.hash_no_pad_plain(x)],
             canonical=False, plain="ops.poseidon.hash_no_pad", width=width, B=K * L,
             leaves="K trees, copied from the transposed LDE")
    x = rand_field(rng, (K * L // 2, 8), device)
    hold("hash_no_pad_cuda", [pc.hash_no_pad_cuda(x)], [pc.hash_no_pad_plain(x)], canonical=False,
         plain="ops.poseidon.hash_no_pad", width=8, B=K * L // 2)
    del x

    args = perm_columns_inputs(rng, device, K, C, R, n, extra_rows=W - R)
    hold("perm_columns_cuda", pcol.perm_columns_cuda(*args), pcol.perm_columns_plain(*args),
         plain="perm_columns_plain", K=K, C=C, R=R, n=n, wire_rows=W)
    args, zero_at = perm_columns_edge_inputs(rng, device, K, C, R, n)
    hold("perm_columns_cuda", pcol.perm_columns_cuda(*args), pcol.perm_columns_plain(*args),
         plain="perm_columns_plain", K=K, C=C, R=R, n=n, inputs="edge lanes",
         zero_g_total_at=zero_at)
    for edge in (False, True):
        args = perm_quotient_inputs(rng, device, K, C, R, L, extra_rows=W - R, edge=edge)
        hold("perm_quotient_cuda", pq.perm_quotient_cuda(*args, blowup),
             pq.perm_quotient_plain(*args, blowup), plain="perm_quotient_plain", K=K, C=C, R=R,
             L=L, wire_rows=W, inputs="edge lanes" if edge else "random")
        field = edge_field if edge else rand_field
        args = [field(rng, (K, W, L), device), field(rng, (L,), device),
                field(rng, (K, C), device), field(rng, (K, C, L), device),
                field(rng, (K, C), device)]
        hold("poseidon_gate_quotient_cuda", gqc.poseidon_gate_quotient_cuda(*args),
             gqc.poseidon_gate_quotient_plain(*args), plain="poseidon_gate_quotient_plain",
             K=K, C=C, L=L, wire_rows=W, inputs="edge lanes" if edge else "random")
        del args

    batch = batch_points(zm.batch_layout(), L)
    span = zm.batch_layout()[0] * zm.batch_layout()[1]
    for lead in ((K * C,), (K, C)):
        acc, z_h = edge_field(rng, lead + (L,), device), edge_field(rng, (L,), device)
        z_h[[batch[0], batch[len(batch) // 2], batch[-1]]] = 0
        z_h[[t + 2 for t in batch]] = 0
        z_h[2 * span : 3 * span] = 0
        got = zm.zinv_mul_cuda(acc, z_h)
        hold("zinv_mul_cuda", [got], [zm.zinv_mul_plain(acc, z_h)], plain="zinv_mul_plain",
             rows=list(lead), L=L, inputs="edge lanes, planted zeros", thread_zeros_at=batch,
             block_zeros_from=2 * span, to=3 * span)
        if not torch.equal(got != 0, (acc != 0) & (z_h != 0)):
            raise RuntimeError("zinv_mul_cuda: a zero of z_h reached another lane")
    # Z_H as the prover has it: `blowup` distinct values along the coset
    acc = rand_field(rng, (K, C, L), device)
    z_h = rand_field(rng, (blowup,), device).repeat(L // blowup)
    hold("zinv_mul_cuda", [zm.zinv_mul_cuda(acc, z_h)], [zm.zinv_mul_plain(acc, z_h)],
         plain="zinv_mul_plain", rows=[K, C], L=L, z_h="8 distinct values")

    args = fri_initial_inputs(rng, device, K, L)
    hold("fri_initial_cuda", [fi.fri_initial_cuda(*args)], [fi.fri_initial_plain(*args)],
         plain="fri_initial_plain", K=K, L=L)
    batch = batch_points(fi.batch_layout(), L)
    xs = gl.from_u64(rng.integers(0, P, size=L, dtype=np.uint64), device)  # distinct points
    args = [edge_field(rng, (K, L, 2), device), edge_field(rng, (K, L, 2), device), xs]
    args += [edge_field(rng, (K, 2), device) for _ in range(4)]
    zeros = []
    for k in range(K):
        i = (0, len(batch) // 2, len(batch) - 1)[k % 3]
        args[3][k] = torch.stack([xs[batch[i]], xs.new_zeros(())])
        args[4][k] = torch.stack([xs[batch[i] + 1], xs.new_zeros(())])
        zeros += [batch[i], batch[i] + 1]
    hold("fri_initial_cuda", [fi.fri_initial_cuda(*args)], [fi.fri_initial_plain(*args)],
         plain="fri_initial_plain", K=K, L=L, inputs="edge lanes, planted zero norms",
         zero_norms_at=zeros)
    del args

    for name, (B, length, inverse) in ntt_batch_shapes(log_rows, K).items():
        x = rand_field(rng, (B, length), device)
        for inv in (False, True):
            hold("ntt_cuda", [nc.ntt_cuda(x, inv)], [nc.ntt_plain(x, inv)],
                 plain="ops.ntt._ntt_impl", name=name, B=B, n=length, inverse=inv)
        hold("ntt_cuda", [nt.intt(nt.ntt(x))], [x], against="intt(ntt(x)) == x", B=B, n=length)
        x = edge_field(rng, (B, length), device)
        hold("ntt_cuda", [nc.ntt_cuda(x, inverse)], [nc.ntt_plain(x, inverse)],
             plain="ops.ntt._ntt_impl", name=name, B=B, n=length, inverse=inverse,
             inputs="edge lanes")
        del x
    torch.cuda.synchronize()
    if any(worst.values()) or any(err.values()):
        raise RuntimeError(f"kernel disagrees with its plain version: {worst} {err}")
    return err


def read_flow_golden(path):
    """(the user-tx circuit's digest, the five proofs' hashes) of
    ``golden/user_tx_flow_standard.sha256``."""
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln and not ln.startswith("#")]
    tag, *limbs = lines[0].split()[:5]
    if tag != "circuit_digest":
        raise RuntimeError(f"{path}: no circuit_digest line")
    return tuple(int(x) for x in limbs), [ln.split()[0] for ln in lines[1:6]]


def launch_diff(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after if after[k] - before.get(k, 0)}


def phase_user_tx(golden_path):
    """The block flow's first stages on the card
    (``models/rollup/block_flow.py::prove_user_txs_and_signatures`` at
    ``RollupConstants.test_constants()`` and ``standard_recursion_config``):
    the user-transaction circuit (4,096 rows, LDE 2^15), the K = 3 batch of
    sender 1's, sender 2's (its deposit merge) and the default transaction in
    the chained wiring, the proposal, the zkDSA circuit and the K = 2 batch of
    the signatures.  Each user-tx proof must equal a sequential ``prove`` of
    its witness on the card, decode to the public inputs its witness gives,
    with tx_hash = two_to_one(diff_root, nonce), verify, have a tampered copy
    rejected and hash to the golden.  Returns the stages, the flow's
    timings and the golden hashes of the signatures."""
    from intmax_zkp_core_tpu_torch.models.rollup import block_flow as bf
    from intmax_zkp_core_tpu_torch.models.transaction.circuits import (
        MergeAndPurgeTransitionPublicInputs,
    )
    from intmax_zkp_core_tpu_torch.utils.poseidon_host import two_to_one

    golden_digest, golden = read_flow_golden(golden_path)
    timings = {}
    t0 = time.perf_counter()
    stages = bf.prove_user_txs_and_signatures(timings=timings)
    torch.cuda.synchronize()
    flow_s = time.perf_counter() - t0
    data = stages.user_tx_circuit.data
    common = data.common
    if tuple(common.circuit_digest) != golden_digest:
        raise RuntimeError("the user-tx circuit's digest differs from the JAX package's")
    K = len(stages.user_tx_proofs)
    if common.n != 1 << USER_TX_LOG_ROWS or K != USER_TX_K:
        raise RuntimeError(f"the user-tx batch is {K} proofs of {common.n} rows, not "
                           f"{USER_TX_K} of 2^{USER_TX_LOG_ROWS}")
    sequential, sequential_s = [], []
    for pw in stages.user_tx_witnesses:
        t0 = time.perf_counter()
        sequential.append(data.prove(pw))
        torch.cuda.synchronize()
        sequential_s.append(round(time.perf_counter() - t0, 3))
    verify_s = []
    for k, (proof, sp) in enumerate(zip(stages.user_tx_proofs, sequential)):
        if proof != sp:
            raise RuntimeError(f"user-tx batch proof {k} differs from the sequential proof")
        pis = MergeAndPurgeTransitionPublicInputs.decode(proof.public_inputs)
        if pis != stages.user_tx_public_inputs[k]:
            raise RuntimeError(f"user-tx proof {k}'s public inputs are not its witness's")
        if pis.tx_hash != two_to_one(pis.diff_root, stages.user_tx_nonces[k]):
            raise RuntimeError(f"user-tx proof {k}: tx_hash != two_to_one(diff_root, nonce)")
        t0 = time.perf_counter()
        data.verify(proof)
        verify_s.append(round(time.perf_counter() - t0, 3))
        expect_rejected(data, proof)
        if proof_sha256(proof) != golden[k]:
            raise RuntimeError(f"user-tx proof {k} hash {proof_sha256(proof)} != golden {golden[k]}")
    log("user-tx", rows=common.n, records=len(data.prover.generators),
        gates=",".join(common.gate_ids), circuit_digest="equal", K=K,
        build_s=round(timings["build_user_tx_circuit"], 3),
        state_setup_s=round(timings["state_setup"], 3),
        batch_prove_s=round(timings["prove_user_txs"], 3), sequential_prove_s=sequential_s,
        verify_s=verify_s, batch_equals_sequential=True, public_inputs="as the witnesses give",
        tampered="rejected", golden="equal", flow_s=round(flow_s, 3))
    log("user-tx-phases", wiring="chained", K=K,
        **{k: round(v, 4) for k, v in timings["prove_user_txs_phases"].items()})
    return stages, timings, golden[3:]


def phase_signatures(stages, timings, golden):
    """The K = 2 zkDSA batch of the flow's ``prove_signatures`` (chained
    wiring) and the same batch once more in the fused wiring: both proofs of
    each equal the sequential proofs and the golden, and verify; the fused
    batch launches K1b."""
    from intmax_zkp_core_tpu_torch.engine.prover import prove_batch
    from intmax_zkp_core_tpu_torch.ops import poseidon_cuda as pc

    data = stages.zkdsa_circuit.data
    torch.cuda.synchronize()
    before, t0 = pc.launch_counts(), time.perf_counter()
    fused = prove_batch(data, stages.signature_witnesses, fused_sponge=True)
    torch.cuda.synchronize()
    fused_s, fused_launches = time.perf_counter() - t0, launch_diff(pc.launch_counts(), before)
    if fused_launches.get("hash_no_pad_cuda", 0) <= 0:
        raise RuntimeError("the fused-wiring signature batch launched no hash_no_pad_cuda")
    sequential = [data.prove(pw) for pw in stages.signature_witnesses]
    for k, (chained, fused_k, sp) in enumerate(zip(stages.signature_proofs, fused, sequential)):
        if not chained == fused_k == sp:
            raise RuntimeError(f"signature proof {k} differs between the batches and sequential")
        if proof_sha256(sp) != golden[k]:
            raise RuntimeError(f"signature proof {k} hash {proof_sha256(sp)} != golden {golden[k]}")
        data.verify(chained)
    expect_rejected(data, stages.signature_proofs[0])
    log("signatures", K=len(fused), rows=data.common.n,
        build_s=round(timings["build_zkdsa_circuit"], 3),
        chained_batch_prove_s=round(timings["prove_signatures"], 3),
        fused_batch_prove_s=round(fused_s, 3), batches_equal_sequential=True, golden="equal",
        verified=True, tampered="rejected", fused_launches=fused_launches)


# The __global__ function behind each wrapper, by the name the profiler sees.
KERNEL_SYMBOLS = {
    "permute_kernel": "permute_cuda",
    "hash_no_pad_kernel": "hash_no_pad_cuda",
    "perm_columns_rows_kernel": "perm_columns_cuda",
    "perm_columns_carries_kernel": "perm_columns_cuda",
    "perm_columns_finish_kernel": "perm_columns_cuda",
    "perm_quotient_kernel": "perm_quotient_cuda",
    "zinv_mul_kernel": "zinv_mul_cuda",
    "fri_initial_kernel": "fri_initial_cuda",
    "gate_quotient_kernel": "poseidon_gate_quotient_cuda",
    "ntt_local_kernel": "ntt_cuda",
}


PROFILE_TRIES, WARM_UP_LAUNCHES = 5, 100


def profiled_run(prove, **fields):
    """``prove()`` under torch.profiler (device activity only), the launch
    counts set to 0 just before it and read just after.  The profiler loses
    the first few device records of a trace now and then (a block proof's
    host-to-device copy and first NTT launches, most often), so each trace
    opens with ``WARM_UP_LAUNCHES`` empty spin kernels, which no sum counts;
    a trace whose events still do not equal the launches is taken again, up
    to ``PROFILE_TRIES`` times (the proofs are deterministic).  Fails unless
    one trace saw one event and some device time for every launch, and no
    event of a kernel not launched.  Logs a ``[kernel-time]`` line with
    ``fields`` and the number of traces taken; returns what ``prove()`` gave
    and {kernel: {"ms", "launches"}}."""
    from torch.profiler import ProfilerActivity, profile

    from intmax_zkp_core_tpu_torch.ops import poseidon_cuda as pc

    short = []
    for tries in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(WARM_UP_LAUNCHES):
                torch.cuda._sleep(0)
            torch.cuda.synchronize()
            pc.reset_launch_counts()
            t0 = time.perf_counter()
            result = prove()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = {k: n for k, n in pc.launch_counts().items() if n}
        ms, events, all_ms = {}, {}, 0.0
        for ev in prof.key_averages():
            if "spin_kernel" in ev.key:
                continue
            us = ev.device_time_total
            all_ms += us / 1e3
            name = next((w for sym, w in KERNEL_SYMBOLS.items() if sym in ev.key), None)
            if name:
                ms[name] = ms.get(name, 0.0) + us / 1e3
                events[name] = events.get(name, 0) + ev.count
        if events == launches:
            break
        short.append({k: (events.get(k, 0), n) for k, n in launches.items()
                      if events.get(k, 0) != n})
    else:
        raise RuntimeError(f"{fields}: in {PROFILE_TRIES} traces the profiler's events never "
                           f"equalled the launches: (events, launches) {short}")
    rows = {k: {"ms": round(ms[k], 4), "launches": n} for k, n in launches.items()}
    if not all(row["ms"] > 0 for row in rows.values()):
        raise RuntimeError(f"the profiler saw no device time for a launched kernel: {rows}")
    log("kernel-time", **fields, source="torch.profiler", traces=tries, prove_s=round(wall, 3),
        device_ms_all_kernels=round(all_ms, 3),
        device_ms_port_kernels=round(sum(row["ms"] for row in rows.values()), 3),
        events_equal_launches=True, **rows)
    return result, rows


def phase_kernel_time(circuit, seed, salt) -> dict:
    """Device milliseconds per proof of each kernel: one more chain proof of
    each wiring under ``profiled_run``, beside the launches counted in it."""
    return {wiring: profiled_run(lambda: circuit.prove(seed, salt, fused_sponge=fused),
                                 wiring=wiring)[1]
            for wiring, fused in (("chained", False), ("fused", True))}


def phase_user_tx_kernel_time(stages) -> dict:
    """Device milliseconds and launches of each kernel in one more user-tx
    batch (``prove_batch`` of the flow's three witnesses, chained wiring)
    and in one more sequential proof of its first witness, each under
    ``profiled_run``.  Both must give the flow's proofs; K3 - K7 must be
    launched as often per batch as per single proof, and K2 as the call
    sites of a batch and of a proof both say."""
    from intmax_zkp_core_tpu_torch.engine.prover import prove_batch

    data, pws = stages.user_tx_circuit.data, stages.user_tx_witnesses
    batch, per_batch = profiled_run(lambda: prove_batch(data, pws), path="user_tx", per="batch",
                                    K=len(pws))
    proof, per_proof = profiled_run(lambda: data.prove(pws[0]), path="user_tx", per="proof", K=1)
    if batch != stages.user_tx_proofs or proof != stages.user_tx_proofs[0]:
        raise RuntimeError("a profiled user-tx proof differs from the flow's")
    count = lambda rows, name: rows.get(name, {}).get("launches")  # noqa: E731
    for name, want in launches_per_proof().items():
        if not count(per_batch, name) == count(per_proof, name) == want:
            raise RuntimeError(f"{name}: {count(per_batch, name)} launches per batch, "
                               f"{count(per_proof, name)} per proof, not {want}")
    want = ntt_launches_per_proof(data.common)
    if not count(per_batch, "ntt_cuda") == count(per_proof, "ntt_cuda") == want:
        raise RuntimeError(f"ntt_cuda: {count(per_batch, 'ntt_cuda')} launches per batch, "
                           f"{count(per_proof, 'ntt_cuda')} per proof, not {want}")
    log("user-tx-launches", k3_to_k7="equal per batch and per proof",
        k1_per_batch=count(per_batch, "permute_cuda"), k1_per_proof=count(per_proof, "permute_cuda"),
        k2_per_batch=count(per_batch, "ntt_cuda"), k2_per_proof=count(per_proof, "ntt_cuda"))
    return {"batch": per_batch, "proof": per_proof}


BLOCK_LOG_ROWS, BATCH_LOG_ROWS = 16, 15  # the recursive block circuit at test_constants; the batch
# the block circuit's one public input, as the JAX package's check mode of the flow gives it
ENTRY_HASH = (9738196181870042524, 11696639860342013396, 1907484470672876494, 3974110925381116255)


def read_block_golden(path) -> dict:
    """{"block": (rows, digest, proof hash), "batch": (...)} of
    ``golden/block_flow_standard.sha256``."""
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln and not ln.startswith("#")]
    out = {}
    for name, (digest_line, proof_line) in zip(("block", "batch"), (lines[0:2], lines[2:4])):
        tag, *limbs = digest_line.split()[:5]
        if tag != "circuit_digest":
            raise RuntimeError(f"{path}: no circuit_digest line for the {name} circuit")
        rows = int(digest_line.split(";")[1].split()[0])
        out[name] = (rows, tuple(int(x) for x in limbs), proof_line.split()[0])
    return out


def phase_block(stages, golden, block_info_path):
    """The block path: ``run_block_flow(prove=True, recursive=True)`` on the
    card at ``test_constants`` and ``standard_recursion_config``, on the
    user-tx and signature stages the user-tx path proved already (the flow
    takes them as ``stages=``): the recursive block circuit (2^16 rows, LDE
    2^19; four user-tx and four zkDSA proofs verified in the circuit), its
    witness, its proof in the chained wiring and its verification; then the
    same witness proved in the fused wiring.  The circuit's digest and the
    proof's hash must equal the JAX-made golden, ``BlockInfo`` the
    committed ``test_cases/block1_info.json``, the public input the entry
    hash of the JAX package's check mode; a tampered proof is rejected.
    Returns the flow's result and the block circuit's partial witness."""
    from intmax_zkp_core_tpu_torch.models.rollup import block_flow as bf

    rows, digest, block_hash = golden["block"]
    timings = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = bf.run_block_flow(prove=True, recursive=True, stages=stages, timings=timings)
    torch.cuda.synchronize()
    flow_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    block = res.block_circuit
    data, common = block.data, block.data.common
    if common.n != rows or common.n != 1 << BLOCK_LOG_ROWS:
        raise RuntimeError(f"the block circuit has {common.n} rows, the golden {rows}")
    if tuple(common.circuit_digest) != digest:
        raise RuntimeError("the block circuit's digest differs from the JAX package's")
    proof = res.block_proof.proof
    if proof_sha256(proof) != block_hash:
        raise RuntimeError(f"block proof hash {proof_sha256(proof)} != golden {block_hash}")
    with open(block_info_path) as f:
        if res.block_info.to_json() != json.load(f):
            raise RuntimeError("BlockInfo differs from test_cases/block1_info.json")
    if res.block_proof.public_inputs.get_entry_hash().elements != ENTRY_HASH:
        raise RuntimeError("the block's entry hash differs from the JAX check mode's")
    if proof.public_inputs != list(ENTRY_HASH):
        raise RuntimeError("the block proof's public input is not the entry hash")
    expect_rejected(data, proof)
    phases = timings["prove_block_phases"]
    kinds = {}
    for record in data.prover.generators:
        kinds[record[0]] = kinds.get(record[0], 0) + 1
    log("block", rows=common.n, gate_rows=len(data.prover.rows),
        records=len(data.prover.generators), ext_inverse_records=kinds.get("ext_inverse", 0),
        gates=",".join(common.gate_ids), circuit_digest="equal", proof="equal to the golden",
        block_info="equal to test_cases/block1_info.json", entry_hash="equal",
        tampered="rejected", build_s=round(timings["build_block_circuit"], 3),
        block_state_s=round(timings["block_state"], 3),
        witness_s=round(timings["block_witness"], 3), fill_s=round(phases["witness"], 3),
        prove_s=round(timings["prove_block"], 3), verify_s=round(timings["verify_block"], 3),
        max_memory_allocated_bytes=peak, flow_s=round(flow_s, 3))
    log("block-phases", wiring="chained", **{k: round(v, 4) for k, v in phases.items()})
    expect_parts_add_up(phases)

    pw, _ = block.witness(res.block_detail, stages.user_tx_proofs[2], stages.signature_proofs[1])
    fused_timings = {}
    t0 = time.perf_counter()
    fused = data.prove(pw, fused_sponge=True, timings=fused_timings)
    torch.cuda.synchronize()
    if proof_sha256(fused) != proof_sha256(proof):
        raise RuntimeError("the fused-wiring block proof differs from the chained one")
    log("block-fused", prove_s=round(time.perf_counter() - t0, 3), proof="equal",
        **{k: round(v, 4) for k, v in fused_timings.items()})
    return res, pw


def phase_batch(res, golden):
    """The batch proof of ``bin/block_circuit.py`` (``prove_batch_over``):
    the batch circuit over ``n_blocks`` = 2 recursive block proofs, the block
    proof in the first slot and, disabled, in the second; its digest and
    proof hash must equal the JAX-made golden; it verifies and a tampered
    copy is rejected.  Returns what ``prove_batch_over`` gave."""
    from intmax_zkp_core_tpu_torch.bin.block_circuit import prove_batch_over

    rows, digest, batch_hash = golden["batch"]
    timings = {}
    torch.cuda.reset_peak_memory_stats()
    batch = prove_batch_over(res.block_circuit, [res.block_proof.proof], timings=timings)
    peak = torch.cuda.max_memory_allocated()
    common = batch.data.common
    if common.n != rows or common.n != 1 << BATCH_LOG_ROWS:
        raise RuntimeError(f"the batch circuit has {common.n} rows, the golden {rows}")
    if tuple(common.circuit_digest) != digest:
        raise RuntimeError("the batch circuit's digest differs from the JAX package's")
    if proof_sha256(batch.proof) != batch_hash:
        raise RuntimeError(f"batch proof hash {proof_sha256(batch.proof)} != golden {batch_hash}")
    expect_rejected(batch.data, batch.proof)
    log("batch", n_blocks=res.block_circuit.constants.n_blocks, disabled_slots=1, rows=common.n,
        gate_rows=len(batch.data.prover.rows), records=len(batch.data.prover.generators),
        circuit_digest="equal", proof="equal to the golden", tampered="rejected",
        build_s=round(timings["build_batch_circuit"], 3),
        witness_s=round(timings["batch_witness"], 3),
        prove_s=round(timings["prove_batch"], 3), verify_s=round(timings["verify_batch"], 3),
        max_memory_allocated_bytes=peak)
    log("batch-phases", **{k: round(v, 4) for k, v in timings["prove_batch_phases"].items()})
    return batch


def phase_block_plain(res, pw, batch) -> None:
    """The block proof and the batch proof once more with the plain versions
    on the card (``plain_path_proof``): every kernel held against its plain
    version at every shape and on every input of both proofs."""
    data = res.block_circuit.data
    block_s = plain_path_proof(lambda: data.prove(pw), res.block_proof.proof)
    batch_s = plain_path_proof(lambda: batch.data.prove(batch.witness), batch.proof)
    log("block-plain", path="block", block_prove_s=round(block_s, 3),
        batch_prove_s=round(batch_s, 3), proofs="equal", kernels_launched=0)


def phase_block_kernel_time(res, pw) -> dict:
    """Device milliseconds and launches of each kernel per block proof: one
    more block proof of each wiring under ``profiled_run``; both must give the
    flow's proof."""
    data, proof = res.block_circuit.data, res.block_proof.proof
    out = {}
    for wiring, fused in (("chained", False), ("fused", True)):
        got, out[wiring] = profiled_run(lambda: data.prove(pw, fused_sponge=fused),
                                        path="block", per="proof", wiring=wiring)
        if got != proof:
            raise RuntimeError(f"a profiled block proof ({wiring}) differs from the flow's")
    count = lambda name: out["chained"].get(name, {}).get("launches")  # noqa: E731
    for name, want in launches_per_proof().items():
        if count(name) != want:
            raise RuntimeError(f"{name}: {count(name)} launches per block proof, not {want}")
    if count("ntt_cuda") != ntt_launches_per_proof(data.common):
        raise RuntimeError(f"ntt_cuda: {count('ntt_cuda')} launches per block proof")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log-rows", type=int, default=15,
                    help="height of the hash-chain circuit (>= 11; default 15)")
    ap.add_argument("--ptxas", action="store_true", help="print ptxas -v while building")
    args = ap.parse_args()
    if args.log_rows < 11:
        ap.error("--log-rows must be at least 11")
    t_start = time.perf_counter()

    # ---- 1. device ----
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    # the port itself: fails here, before anything is printed, where the
    # script stands alone without the package
    from intmax_zkp_core_tpu_torch.ops import cuda_build as cb
    from intmax_zkp_core_tpu_torch.ops import poseidon_cuda as pc

    card = nvidia_smi_line()
    log("device", torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0], kind=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), **toolchain_probe(pc.find_nvcc()))
    print(card, flush=True)

    # ---- 2. build ----
    build_seconds = cb.build(verbose=args.ptxas)
    cb.load()
    log("build", sources=[os.path.basename(src) for src in cb.sources()],
        nvcc_flags="'" + " ".join(cb.NVCC_FLAGS) + "'", seconds=round(build_seconds, 2))
    cuobjdump = find_cuobjdump(pc.find_nvcc())
    if cuobjdump is None:
        log("sass", cuobjdump="absent")
    else:
        log("sass", library=os.path.relpath(cb.LIBRARY), **sass_counts(cb.LIBRARY, cuobjdump))

    # ---- 3. kernels against their plain versions; the host C++ ----
    rng = np.random.default_rng(20240917)
    phase_native(rng)
    paths = {"chain": args.log_rows, "smt": SMT_LOG_ROWS}  # each main path's log2 rows
    err = phase_kernels(device, rng, paths)
    err.update(phase_perm_kernels(device, rng, paths))
    err.update(phase_gate_ntt_kernels(device, rng, paths))
    for name, e in phase_user_tx_kernels(device, rng, USER_TX_LOG_ROWS, USER_TX_K).items():
        err[name] = max(err[name], e)
    for name, e in phase_user_tx_kernels(device, rng, BLOCK_LOG_ROWS, 1, path="block").items():
        err[name] = max(err[name], e)
    timing = phase_timings(device, rng)
    timing.update(phase_perm_timings(device, rng, args.log_rows))
    timing.update(phase_gate_ntt_timings(device, rng, args.log_rows))

    # ---- 4./5. the main path, launch counts read around it ----
    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "intmax_zkp_core_tpu_torch", "golden", "zkdsa_standard.sha256")
    pc.reset_launch_counts()
    phase_zkdsa(device, golden)
    chain, chain_timings = phase_chain(device, args.log_rows)
    main_counts = pc.launch_counts()  # read just after the main path
    if len(main_counts) != 8:
        raise RuntimeError(f"expected the counts of eight kernels, got {main_counts}")
    for name, count in main_counts.items():
        if count <= 0:
            raise RuntimeError(f"kernel {name} was not launched on the main path")
    # the SMT path, its counts set to 0 just before it and read just after
    pc.reset_launch_counts()
    smt_per_proof = phase_smt(os.path.join(os.path.dirname(golden),
                                           "smt_process_256_standard.sha256"))
    smt_counts = pc.launch_counts()
    for name, count in smt_counts.items():
        if count <= 0:
            raise RuntimeError(f"kernel {name} was not launched on the SMT path")
    log("smt-launches", path=smt_counts, per_proof=smt_per_proof[0])
    # the user-tx path (the block flow's user-tx and signature batches), its
    # counts set to 0 just before it and read just after
    pc.reset_launch_counts()
    stages, flow_timings, sig_golden = phase_user_tx(
        os.path.join(os.path.dirname(golden), "user_tx_flow_standard.sha256"))
    phase_signatures(stages, flow_timings, sig_golden)
    user_tx_counts = pc.launch_counts()
    for name, count in user_tx_counts.items():
        if count <= 0:
            raise RuntimeError(f"kernel {name} was not launched on the user-tx path")
    log("user-tx-path-launches", path=user_tx_counts)
    # the block path (the flow's recursive block proof on those stages, both
    # wirings, and the batch proof over it), its counts set to 0 just before
    # it and read just after
    golden_dir = os.path.dirname(golden)
    block_golden = read_block_golden(os.path.join(golden_dir, "block_flow_standard.sha256"))
    pc.reset_launch_counts()
    block_res, block_pw = phase_block(
        stages, block_golden, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                           "test_cases", "block1_info.json"))
    batch = phase_batch(block_res, block_golden)
    block_counts = pc.launch_counts()
    if len(block_counts) != 8:
        raise RuntimeError(f"expected the counts of eight kernels, got {block_counts}")
    for name, count in block_counts.items():
        if count <= 0:
            raise RuntimeError(f"kernel {name} was not launched on the block path")
    log("block-launches", path=block_counts)
    # comparisons only: after the counts were read
    phase_chain_witness(*chain[:3], *chain_timings)
    phase_chain_plain(*chain)
    per_proof = phase_kernel_time(*chain[:3])
    user_tx_time = phase_user_tx_kernel_time(stages)
    phase_block_plain(block_res, block_pw, batch)
    block_time = phase_block_kernel_time(block_res, block_pw)

    # ---- 6. the record ----
    csrc, ref = "intmax_zkp_core_tpu_torch/csrc/", "intmax_zkp_core_tpu/ops/"
    table = (
        ("permute_cuda", "poseidon.cu", "poseidon_pallas.py:358", "permute_cuda"),
        ("hash_no_pad_cuda", "poseidon.cu", "poseidon_pallas.py:291", "hash_no_pad_cuda_w135"),
        ("perm_columns_cuda", "perm_columns.cu", "perm_columns_pallas.py:198", "perm_columns_cuda"),
        ("perm_quotient_cuda", "perm_quotient.cu", "perm_quotient_pallas.py:193", "perm_quotient_cuda"),
        ("zinv_mul_cuda", "zinv_mul.cu", "zinv_mul_pallas.py:90", "zinv_mul_cuda"),
        ("fri_initial_cuda", "fri_init.cu", "fri_init_pallas.py:159", "fri_initial_cuda"),
        ("poseidon_gate_quotient_cuda", "gate_quotient.cu", "gate_quotient_pallas.py:279",
         "poseidon_gate_quotient_cuda"),
        ("ntt_cuda", "ntt.cu", "ntt_pallas.py:227", "ntt_cuda"),
    )
    kernels = []
    for name, source, replaces, timed in table:
        t = timing[timed]
        wiring = "fused" if name == "hash_no_pad_cuda" else "chained"
        kernels.append(
            {"name": name, "route": "cuda", "source": csrc + source, "replaces": ref + replaces,
             "launches": main_counts[name], "launches_smt": smt_counts[name],
             "launches_user_tx": user_tx_counts[name],
             "launches_user_tx_batch": user_tx_time["batch"].get(name, {}).get("launches", 0),
             "ms_per_user_tx_batch": user_tx_time["batch"].get(name, {}).get("ms"),
             "max_abs_err": err[name],
             "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
             "bound_by": t["bound_by"], "library_ms": None,
             "bound_ms_as_computed": t["bound_ms_as_computed"], "shape": t["shape"],
             "ms_per_proof": per_proof[wiring][name]["ms"],
             "launches_per_proof": per_proof[wiring][name]["launches"],
             "launches_block": block_counts[name],
             "ms_per_block_proof": block_time[wiring][name]["ms"],
             "launches_per_block_proof": block_time[wiring][name]["launches"]})
    log("done", seconds=round(time.perf_counter() - t_start, 1), log_rows=args.log_rows)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
