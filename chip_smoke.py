#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--log-rows N] [--ptxas]

Builds the CUDA kernels from ``intmax_zkp_core_tpu_torch/csrc`` with nvcc,
holds each against its plain PyTorch version on the card (bit-identical:
tolerance 0), then drives the port's main path — build a circuit, prove,
verify — for the zkDSA signature circuit and for a Poseidon hash-chain
circuit of 2^N rows (default 15, the block circuit's height) at
``CircuitConfig.standard_recursion_config()``.  Prints one line per phase, a
JSON line describing every kernel, and a last JSON line ``{"ok": true, ...}``.
Any failed phase raises and the script exits non-zero; without a CUDA device
it exits 1 at once.

In the kernels line ``max_abs_err`` is the largest absolute difference
between a kernel's output and its plain version's, taken on the int64 bit
patterns in float64 over every shape compared; the script fails unless it
is 0.  ``bound_ms`` counts the multiply-adds of the cheapest known way to
compute the permutation, ``bound_ms_as_computed`` those of the kernels' own
algorithm.
"""

from __future__ import annotations

import argparse
import hashlib
import json
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
# What the kernels' own algorithm spends: every S-box multiply as 4 partial
# products and a dense MDS layer in each of the 30 rounds.  Reported beside
# the bound, never as the bound.
MADS_AS_COMPUTED = SBOXES * 4 * 4 + 30 * MDS_LAYER_MADS


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


def rand_field(rng, shape, device) -> torch.Tensor:
    """Canonical field elements with lanes of 0 and p-1 mixed in."""
    from intmax_zkp_core_tpu_torch.ops import goldilocks as gl

    a = rng.integers(0, P, size=shape, dtype=np.uint64)
    flat = a.reshape(-1)
    flat[:: 7] = 0
    flat[3 :: 11] = P - 1
    return gl.from_u64(a, device)


def mismatches(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a != b).sum().item())


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| over the int64 bit patterns, in float64."""
    return float((a.double() - b.double()).abs().max().item())


def time_ms(fn, reps: int, flush: torch.Tensor | None = None) -> float:
    """Mean milliseconds of ``fn()`` on the card over ``reps`` runs (CUDA
    events; one warm-up; the L2 cache is overwritten between runs when a
    flush buffer is given)."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def bound_ms(rows: int, width_in: int, width_out: int, perms_per_row: int) -> dict:
    """The least time the card could take: the larger of bytes over the
    memory rate and needed multiply-adds over the integer rate."""
    bytes_ms = rows * (width_in + width_out) * 8 / HBM_BYTES_PER_S * 1e3
    per_mad_ms = rows * perms_per_row / INT32_MAD_PER_S * 1e3
    ops_ms = per_mad_ms * MADS_PER_PERMUTATION
    return {
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "bound_ms_as_computed": max(per_mad_ms * MADS_AS_COMPUTED, bytes_ms),
    }


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


def phase_kernels(device, rng):
    from intmax_zkp_core_tpu_torch.ops import goldilocks as gl
    from intmax_zkp_core_tpu_torch.ops import poseidon as ps
    from intmax_zkp_core_tpu_torch.ops import poseidon_cuda as pc

    worst = {"permute_cuda": 0, "hash_no_pad_cuda": 0}
    err = {"permute_cuda": 0.0, "hash_no_pad_cuda": 0.0}
    for B in (1, 255, 256, 1 << 14, (1 << 18) + 3):
        x = rand_field(rng, (B, 12), device)
        got, want = pc.permute_cuda(x), pc.permute_plain(x)
        bad = mismatches(got, want)
        worst["permute_cuda"] = max(worst["permute_cuda"], bad)
        err["permute_cuda"] = max(err["permute_cuda"], max_abs_err(got, want))
        log("kernels", kernel="permute_cuda", plain="ops.poseidon.permute", B=B, mismatches=bad)
    for width in (2, 5, 8, 12, 16, 24, 100, 135):
        for B in (1, 1 << 18):
            x = rand_field(rng, (B, width), device)
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
                width=width, B=B, mismatches=bad, mismatches_strided=bad_t,
                mismatches_chained=bad_c)
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
        permute_cuda_launches_build=c1["permute_cuda"] - c0["permute_cuda"],
        permute_cuda_launches_prove=c2["permute_cuda"] - c1["permute_cuda"])


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
        permute_cuda_launches_build=after_build["permute_cuda"] - c0["permute_cuda"],
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
    log("chain-phases", **{k: round(v, 4) for k, v in timings.items()})
    after_chained = pc.launch_counts()

    # the same proof through the fused-sponge wiring
    t0 = time.perf_counter()
    fused_timings = {}
    proof_fused = circuit.prove(seed, salt, fused_sponge=True, timings=fused_timings)
    t1 = time.perf_counter()
    after_fused = pc.launch_counts()
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
    return circuit, seed, salt, proof


def phase_chain_plain(circuit, seed, salt, proof):
    """The chain once more with the plain versions on the card: the proof
    must equal the kernel path's, and no kernel may be launched.

    The port has no switch that sends a tensor on the card to the plain
    version, so for this one comparison the permutation wrapper is replaced
    by its plain version here and put back afterwards."""
    from intmax_zkp_core_tpu_torch.ops import poseidon_cuda as pc

    before = pc.launch_counts()
    t0 = time.perf_counter()
    timings = {}
    kernel_wrapper = pc.permute_cuda
    pc.permute_cuda = pc.permute_plain
    try:
        proof_plain = circuit.prove(seed, salt, timings=timings)
    finally:
        pc.permute_cuda = kernel_wrapper
    t1 = time.perf_counter()
    if pc.launch_counts() != before:
        raise RuntimeError("the plain-path proof launched a kernel")
    if proof_sha256(proof_plain) != proof_sha256(proof):
        raise RuntimeError("kernel-path and plain-path proofs differ")
    log("chain-plain", prove_s=round(t1 - t0, 3), proof="equal",
        **{k: round(v, 4) for k, v in timings.items()})


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
    from intmax_zkp_core_tpu_torch.ops import poseidon_cuda as pc

    card = nvidia_smi_line()
    log("device", torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0], kind=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), **toolchain_probe(pc.find_nvcc()))
    print(card, flush=True)

    # ---- 2. build ----
    build_seconds = pc.build(verbose=args.ptxas)
    pc.load()
    log("build", source=os.path.relpath(pc.SOURCE), nvcc_flags="'" + " ".join(pc.NVCC_FLAGS) + "'",
        seconds=round(build_seconds, 2))

    # ---- 3. kernels against their plain versions ----
    rng = np.random.default_rng(20240917)
    err = phase_kernels(device, rng)
    timing = phase_timings(device, rng)

    # ---- 4./5. the main path, launch counts read around it ----
    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "intmax_zkp_core_tpu_torch", "golden", "zkdsa_standard.sha256")
    pc.reset_launch_counts()
    phase_zkdsa(device, golden)
    chain = phase_chain(device, args.log_rows)
    main_counts = pc.launch_counts()  # read just after the main path
    for name, count in main_counts.items():
        if count <= 0:
            raise RuntimeError(f"kernel {name} was not launched on the main path")
    phase_chain_plain(*chain)  # comparison only: after the counts were read

    # ---- 6. the record ----
    src = "intmax_zkp_core_tpu_torch/csrc/poseidon.cu"
    tp, th = timing["permute_cuda"], timing["hash_no_pad_cuda_w135"]
    kernels = [
        {"name": name, "route": "cuda", "source": src,
         "replaces": f"intmax_zkp_core_tpu/ops/poseidon_pallas.py:{line}",
         "launches": main_counts[name], "max_abs_err": err[name],
         "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
         "bound_by": t["bound_by"], "library_ms": None,
         "bound_ms_as_computed": t["bound_ms_as_computed"], "shape": t["shape"]}
        for name, line, t in (("permute_cuda", 358, tp), ("hash_no_pad_cuda", 291, th))
    ]
    log("done", seconds=round(time.perf_counter() - t_start, 1), log_rows=args.log_rows)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
