"""The Plonk-style prover: witness fill -> wire commitment -> permutation
argument -> quotient -> FRI opening proof.

This is the counterpart of ``CircuitData::prove``.  All polynomial work is
batched tensor code on the device; on the host, the witness fill runs in C++
(``native/witness_native.cpp``) and the Fiat-Shamir transcript through the
host C++ permutation, and Python only orchestrates.  When the circuit lives on the card, every NTT runs
through the NTT kernel (``ops/ntt_cuda.py``, reached through ``ops/ntt.py``),
every Merkle commitment hashes through the Poseidon CUDA kernels
(``ops/poseidon_cuda.py``), the permutation argument runs through four more:
the permutation columns (``ops/perm_columns_cuda.py``), the permutation terms
of the quotient (``ops/perm_quotient_cuda.py``), the divide by Z_H
(``ops/zinv_mul_cuda.py``) and the initial FRI quotient
(``ops/fri_init_cuda.py``), and the Poseidon gate's constraints of the
quotient through ``ops/gate_quotient_cuda.py``.  Each wrapper is reached
through its module and picks kernel or plain version by where its tensors
lie.  Everything else is plain PyTorch on int64 bit patterns.

The proof is bit-identical to the JAX package's for the same circuit and
witness: the arithmetic is exact mod p and the transcript deterministic.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..native.witness import native_fill
from ..ops import fri_init_cuda as fi
from ..ops import gate_quotient_cuda as gqc
from ..ops import goldilocks as gl
from ..ops import merkle as mk
from ..ops import ntt as nt
from ..ops import perm_columns_cuda as pcol
from ..ops import perm_quotient_cuda as pq
from ..ops import poseidon as ps
from ..ops import zinv_mul_cuda as zm
from ..ops.perm_quotient_cuda import CHUNK, n_chunks  # noqa: F401  (the verifier reads them here)
from .algebra import BatchAlgebra, ext_add, ext_mul
from .challenger import Challenger
from .circuit import CircuitData
from .fri import FriProof, fold_layers, grind_pow, query_rounds
from .gates import GATE_TYPES
from .witness import PartialWitness, WitnessFill

P = gl.P_INT

# rows of an LDE matrix combined per step of ``_combine_columns``: bounds the
# temporaries of the weighted sum (a [275, 2^18] matrix taken whole needs
# gigabytes of them)
COMBINE_ROW_BLOCK = 64


def _u64_tensor(values, device) -> torch.Tensor:
    """Host ints (transcript challenges, digests) -> int64 bit patterns."""
    return gl.from_u64(np.array(values, dtype=np.uint64), device)


def _gate_quotient_chunk(gate_id: str, num_wires: int, n_const: int, C: int):
    """Function accumulating the alpha-combined, selector-filtered
    constraints of one gate type onto the running quotient numerator:

        acc'[c] = acc[c] + sum_k alphas[c]^k * sel * constraint_k
        apows'[c] = apows[c] * alphas[c]^num_constraints
    """
    gate = GATE_TYPES[gate_id]

    def run(wires_lde, sel_col, const_cols, pi_hash, alphas, acc, apows):
        alg = BatchAlgebra()
        wires_cols = [wires_lde[i] for i in range(num_wires)]
        ccols = [const_cols[i] for i in range(n_const)]
        pi_cols = [pi_hash[i] for i in range(4)]
        batched = getattr(gate, "eval_constraints_batched", None)
        if batched is not None:
            cs = batched(wires_cols, ccols, pi_cols)
        else:
            cs = gate.eval_constraints(alg, wires_cols, ccols, pi_cols)
        out_acc = [acc[c] for c in range(C)]
        out_apows = [apows[c] for c in range(C)]
        for t in cs:
            filt = gl.mul(sel_col, t)
            for c in range(C):
                out_acc[c] = gl.add(out_acc[c], gl.mul(out_apows[c], filt))
                out_apows[c] = gl.mul(out_apows[c], alphas[c])
        return torch.stack(out_acc), torch.stack(out_apows)

    return run


@dataclass
class Proof:
    wires_cap: list
    zs_pp_cap: list
    quotient_cap: list
    openings: dict
    fri: FriProof
    initial_openings: list  # per query: {name: (leaf, path)}
    public_inputs: list


def _open_columns(coeffs: torch.Tensor, zeta: torch.Tensor) -> torch.Tensor:
    """Evaluate S column polynomials [S, n] at an extension point [2];
    returns [S, 2].

    Log-depth even/odd folding instead of an n-step Horner scan:
    ``p(z) = E(z^2) + z * O(z^2)`` halves the coefficient count per fold.
    All arithmetic is exact mod p, so the result is bit-identical to
    Horner."""
    S, n = coeffs.shape
    if n & (n - 1) != 0:
        raise ValueError(f"column length must be a power of two, got {n}")
    cur = torch.stack([coeffs, torch.zeros_like(coeffs)], dim=-1)  # [S, n, 2]
    z = zeta  # [2], then z^2, z^4, ... per fold
    while cur.shape[1] > 1:
        pairs = cur.reshape(S, cur.shape[1] // 2, 2, 2)
        even = pairs[:, :, 0]
        odd = pairs[:, :, 1]
        cur = gl.ext_add(even, gl.ext_mul(odd, z.expand(odd.shape)))
        z = gl.ext_mul(z, z)
    return cur[:, 0]


def _tree_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum of the rows of [m, L] mod p in a log-depth halving tree."""
    m = t.shape[0]
    mp = 1 << max(m - 1, 0).bit_length()
    if mp != m:
        t = torch.cat([t, torch.zeros((mp - m, t.shape[1]), dtype=torch.int64, device=t.device)])
    while t.shape[0] > 1:
        half = t.shape[0] // 2
        t = gl.add(t[:half], t[half:])
    return t[0]


def _combine_columns(lde_matrix: torch.Tensor, pows_arr: torch.Tensor) -> torch.Tensor:
    """sum_i alpha^i * p_i(X): base-field columns [m, lde_n] times extension
    alpha powers [m, 2] -> [lde_n, 2].

    Rows are taken ``COMBINE_ROW_BLOCK`` at a time so the temporaries of the
    weighted terms stay small; modular addition is associative and exact, so
    the sum does not depend on the grouping."""
    lde_n = lde_matrix.shape[1]
    acc0 = torch.zeros(lde_n, dtype=torch.int64, device=lde_matrix.device)
    acc1 = torch.zeros_like(acc0)
    for lo in range(0, lde_matrix.shape[0], COMBINE_ROW_BLOCK):
        block = lde_matrix[lo : lo + COMBINE_ROW_BLOCK]
        pw = pows_arr[lo : lo + COMBINE_ROW_BLOCK]
        acc0 = gl.add(acc0, _tree_sum(gl.mul(block, pw[:, 0:1])))
        acc1 = gl.add(acc1, _tree_sum(gl.mul(block, pw[:, 1:2])))
    return torch.stack([acc0, acc1], dim=-1)  # [lde_n, 2]


def _commit(matrix, rate_bits: int, cap_height: int, from_coeffs: bool = False,
            fused_sponge: bool = False):
    """columns [S, n] (evaluations on the subgroup, or coefficients if
    ``from_coeffs``) on the device -> (coeffs, lde, tree).

    The LDE and the tree levels stay device-resident (``tree`` is a
    ``DeviceMerkleTree``); only the cap is fetched.  The leaves are the
    columns of the LDE: the tree builder gets the transposed *view*, and the
    hashing routes read it through its strides (no materialized transpose)."""
    coeffs = matrix if from_coeffs else nt.intt(matrix)
    lde = nt.coset_lde(coeffs, rate_bits)
    tree = mk.device_merkle_tree(lde.t(), cap_height, fused_sponge=fused_sponge)
    return coeffs, lde, tree


def _cap_tuples(tree) -> list:
    return [tuple(int(x) for x in d) for d in tree.cap]


def _extract_initial_openings(named_trees: dict, indices: list) -> list:
    """Per query index, per commitment: (leaf row, auth path).

    ``named_trees[name] = (lde_dev, lde_np, tree)``.  Device trees
    (``DeviceMerkleTree``) contribute device gathers of just the touched
    rows/digests, combined into ONE small fetch; host trees (numpy levels,
    the constants_sigmas tree of the built circuit) extract directly."""
    idx_np = np.asarray(indices, dtype=np.int64)
    gathers = []
    plan = {}  # name -> ("dev", n_arrays) | ("host",)
    for name, (lde_dev, lde_np, tree) in named_trees.items():
        if isinstance(tree, mk.DeviceMerkleTree):
            idx_dev = torch.from_numpy(idx_np).to(lde_dev.device)
            leaf_rows = lde_dev[:, idx_dev]  # [S, nq]
            paths = tree.path_gathers(idx_np)
            gathers.append(leaf_rows)
            gathers.extend(paths)
            plan[name] = ("dev", 1 + len(paths))
        else:
            plan[name] = ("host",)
    fetched = mk.fetch_arrays(*gathers) if gathers else []
    out = []
    for k, idx in enumerate(indices):
        per = {}
        off = 0
        for name, (lde_dev, lde_np, tree) in named_trees.items():
            mode = plan[name]
            if mode[0] == "dev":
                chunk = fetched[off : off + mode[1]]
                off += mode[1]
                leaf = [int(x) for x in chunk[0][:, k]]
                path = [tuple(int(x) for x in lv[k]) for lv in chunk[1:]]
            else:
                leaf = [int(x) for x in lde_np[:, idx]]
                path = [tuple(int(x) for x in d) for d in tree.prove(idx)]
            per[name] = (leaf, path)
        out.append(per)
    return out


# Per-circuit tables keyed by circuit identity (digest + the remaining
# shape-deciding inputs + device), NOT by object identity: rebuilding a
# CircuitData for the same circuit reuses the device-resident tables.
_KERNELS_CACHE: dict = {}
_KERNELS_CACHE_MAX = 32


def get_circuit_kernels(pd, device):
    """Per-circuit device tables and the functions over them (permutation
    columns, quotient), in a digest-keyed module cache.  Circuit constants
    are uploaded once; challenges are arguments, so every proof of the same
    circuit reuses the tables.  The functions reach the kernel wrappers
    through their modules at call time."""
    device = torch.device(device)
    common = pd.common
    cache_key = (
        common.circuit_digest,
        common.n,
        tuple(common.gate_ids),
        common.n_sel,
        common.n_const_cols,
        tuple(int(k) for k in common.k_is),
        repr(common.config),
        str(device),
    )
    cached = _KERNELS_CACHE.get(cache_key)
    if cached is not None:
        return cached
    cfg = common.config
    n = common.n
    blowup = cfg.fri.blowup
    lde_n = n * blowup
    C = cfg.num_challenges

    n_sel = common.n_sel
    cs_lde_c = gl.from_u64(pd.cs_lde, device)
    sel_lde = cs_lde_c[:n_sel]
    const_lde = cs_lde_c[n_sel : n_sel + common.n_const_cols]
    sigma_lde_c = cs_lde_c[n_sel + common.n_const_cols :]
    k_is_c = _u64_tensor(common.k_is, device)  # [R]

    # coset points x_i = g * w_lde^i and the tables derived from them, all
    # computed on the device (power tables by doubling, one batched Fermat
    # inversion) instead of lde_n-step host loops
    w_lde = gl.primitive_root_of_unity(lde_n.bit_length() - 1)
    g = gl.MULTIPLICATIVE_GROUP_GENERATOR
    xs_c = gl.mul(gl.powers(w_lde, lde_n, device), gl.i64(g % P))
    # x^n on the coset takes only `blowup` distinct values: g^n * w_b^(i % blowup)
    gshift = pow(g, n, P)
    w_b = gl.primitive_root_of_unity(cfg.fri.rate_bits)
    xn_period = _u64_tensor([gshift * pow(w_b, i, P) % P for i in range(blowup)], device)
    z_h_c = gl.sub(xn_period, 1).repeat(lde_n // blowup)
    # L_0(x) = (x^n - 1) / (n * (x - 1))
    l0_c = gl.mul(z_h_c, gl.inv(gl.mul(gl.sub(xs_c, 1), gl.i64(n % P))))
    shift_pows_c = gl.powers(pow(g, P - 2, P), lde_n, device)

    w_pows_c = gl.from_u64(pd.w_pows, device)
    id_vals_c = gl.mul(k_is_c[:, None], w_pows_c[None, :])  # [R, n]
    sigma_c = gl.from_u64(pd.sigma, device)

    def perm_columns(wires, betas, gammas):
        """wires [R, n]; betas/gammas [C] -> (z_cols [C, n], pp [C, nch-1, n],
        wrap [C] which must be all-ones)."""
        z, pp, wrap = pcol.perm_columns_cuda(
            wires[None], betas[None], gammas[None], id_vals_c, sigma_c
        )
        return z[0], pp[0], wrap[0]

    # The alpha-power ordering [L_0 term, permutation chunks, every gate's
    # constraints in gate order] is identical to the verifier's.

    def quotient_perm(wires_lde, zs_lde, pps_lde, betas, gammas, alphas):
        """-> (acc [C, lde_n], apows [C]): the L_0 + permutation-chunk terms
        alpha-combined, and the alpha power reached per challenge."""
        acc, apows = pq.perm_quotient_cuda(
            wires_lde[None], zs_lde[None], pps_lde[None], betas[None], gammas[None],
            alphas[None], sigma_lde_c, xs_c, l0_c, k_is_c, blowup,
        )
        return acc[0], apows[0]

    def quotient_finish(acc):
        """acc [C, lde_n] -> quotient coefficient chunks [C*blowup, n]: the
        divide by Z_H, then iNTT and coset unshift."""
        q_evals = zm.zinv_mul_cuda(acc, z_h_c)
        return gl.mul(nt.intt(q_evals), shift_pows_c).reshape(C * blowup, n)

    sel_cols = [sel_lde[i] for i in range(n_sel)]
    # the Poseidon gate goes through its kernel, every other gate through the
    # plain fold of ``_gate_quotient_chunk``
    gate_chunks = [
        (gi, None if gate_id == "poseidon"
         else _gate_quotient_chunk(gate_id, cfg.num_wires, common.n_const_cols, C))
        for gi, gate_id in enumerate(common.gate_ids)
        if GATE_TYPES[gate_id].num_constraints
    ]

    def quotient_gates(wires_lde, pi_hash, alphas, acc, apows):
        """acc [C, lde_n] plus every gate's selector-filtered constraints,
        alpha-combined from the powers ``apows`` on, gate by gate in the
        verifier's order."""
        for gi, fn in gate_chunks:
            if fn is None:
                acc, apows = gqc.poseidon_gate_quotient_cuda(
                    wires_lde[None], sel_cols[gi], alphas[None], acc[None], apows[None])
                acc, apows = acc[0], apows[0]
            else:
                acc, apows = fn(
                    wires_lde, sel_cols[gi], const_lde, pi_hash, alphas, acc, apows
                )
        return acc

    kernels = {
        "perm_columns": perm_columns,
        # the quotient in its three parts: wires_lde [W, lde_n], zs_lde
        # [C, lde_n], pps_lde [C, nch-1, lde_n], challenges [C], pi_hash [4]
        # -> quotient coefficient chunks [C*blowup, n]
        "quotient_perm": quotient_perm,
        "quotient_gates": quotient_gates,
        "quotient_finish": quotient_finish,
        # device-resident per-circuit tables the rest of prove() reads
        "xs": xs_c,
        "cs_lde_dev": cs_lde_c,
        "cs_coeffs_dev": gl.from_u64(pd.cs_coeffs, device),
    }
    if len(_KERNELS_CACHE) >= _KERNELS_CACHE_MAX:
        # FIFO eviction bounds device-table residency when many distinct
        # circuits are built in one process
        _KERNELS_CACHE.pop(next(iter(_KERNELS_CACHE)))
    _KERNELS_CACHE[cache_key] = kernels
    return kernels


def compute_wire_matrix(pd, pw: PartialWitness):
    """Run witness generation and assemble the [num_wires, n] uint64 matrix
    plus public inputs (shared by prove() and check_witness()).

    The generator fixpoint runs in the host C++ engine
    (``native/witness_native.cpp`` through ``native.witness.native_fill``) and
    the matrix assembles with numpy scatters over the circuit's fill plan,
    built at the first call and cached on ``pd``.  Its plain version is
    ``compute_wire_matrix_plain``."""
    cfg = pd.common.config
    n = pd.common.n
    values, has, wrows, wcols, wvals, plan = native_fill(pd, pw)
    missing = ~has[plan.place_roots].astype(bool)
    if missing.any():
        i = int(np.nonzero(missing)[0][0])
        raise AssertionError(
            "unset wire target at place "
            f"{(int(plan.place_rows[i]), int(plan.place_cols[i]))}"
        )
    wires = np.zeros((cfg.num_wires, n), dtype=np.uint64)
    wires[plan.place_cols, plan.place_rows] = values[plan.place_roots]
    wires[wcols, wrows] = wvals
    assert has[plan.pi_roots].all(), "unset public input"
    public_inputs = [int(v) for v in values[plan.pi_roots]]
    return wires, public_inputs


def compute_wire_matrix_plain(pd, pw: PartialWitness):
    """``compute_wire_matrix`` through the Python ``WitnessFill``: the plain
    version, for comparisons only."""
    cfg = pd.common.config
    n = pd.common.n
    fill = WitnessFill(pd)
    fill.run(pw)
    wires = np.zeros((cfg.num_wires, n), dtype=np.uint64)
    for (row, col), t in pd.targets_at_place.items():
        v = fill.get(t)
        if v is None:
            raise AssertionError(f"unset wire target at place {(row, col)}")
        wires[col, row] = v
    for (row, col), v in fill.wire_overrides.items():
        wires[col, row] = v
    public_inputs = [fill.get(t) for t in pd.public_input_targets]
    assert all(v is not None for v in public_inputs), "unset public input"
    return wires, public_inputs


def check_witness(circuit_data: CircuitData, pw: PartialWitness, device=None) -> list:
    """Fast witness validation: run generators, then evaluate every gate
    constraint on the subgroup rows (no LDE / commitment / FRI).  Raises if
    any constraint is violated; returns the public inputs."""
    pd = circuit_data.prover
    common = pd.common
    cfg = common.config
    device = gl.resolve_device(device if device is not None else circuit_data.device)
    wires, public_inputs = compute_wire_matrix(pd, pw)
    pi_hash = ps.hash_no_pad_s(public_inputs)

    alg = BatchAlgebra()
    n_sel = common.n_sel
    cs = gl.from_u64(pd.constants_sigmas, device)
    sel = cs[:n_sel]
    consts = cs[n_sel : n_sel + common.n_const_cols]
    wires_t = gl.from_u64(wires, device)
    wires_cols = [wires_t[i] for i in range(cfg.num_wires)]
    const_cols = [consts[i] for i in range(common.n_const_cols)]
    pi_hash_cols = list(_u64_tensor(pi_hash, device))

    for gi, gate_id in enumerate(common.gate_ids):
        gate = GATE_TYPES[gate_id]
        if gate.num_constraints == 0:
            continue
        batched = getattr(gate, "eval_constraints_batched", None)
        if batched is not None:
            constraints = batched(wires_cols, const_cols, pi_hash_cols)
        else:
            constraints = gate.eval_constraints(alg, wires_cols, const_cols, pi_hash_cols)
        for k, c in enumerate(constraints):
            vals = gl.to_u64(gl.mul(sel[gi], c))
            bad = np.nonzero(vals)[0]
            if len(bad):
                raise AssertionError(
                    f"constraint {k} of gate '{gate_id}' violated at rows {bad[:5].tolist()}"
                )
    return public_inputs


class _PhaseTimer:
    """Seconds per prover phase, and per part of a phase, into a caller's
    dict.  With a dict given, every boundary synchronizes the device so queued
    work is charged to the interval that enqueued it; without one the timer
    does nothing.  An interval is charged to its phase and, when a part is
    open, to the part too, so the parts of a phase add up to the phase."""

    def __init__(self, timings, device):
        self.timings = timings
        self.device = device
        self._t = None
        self._names = ()

    def _stamp(self, *names) -> None:
        if self.timings is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        for name in self._names:
            self.timings[name] = self.timings.get(name, 0.0) + now - self._t
        self._t = now
        self._names = names

    def phase(self, name, first_part=None) -> None:
        """A new phase begins, with its first part if it has parts (and the
        open phase, with its open part, ends)."""
        self._stamp(*((name,) if first_part is None else (name, first_part)))

    def sub(self, name) -> None:
        """A new part of the open phase begins (and the open part ends)."""
        if self.timings is not None:
            self._stamp(self._names[0], name)


def prove(
    circuit_data: CircuitData,
    pw: PartialWitness,
    device=None,
    fused_sponge: bool = False,
    timings: dict | None = None,
) -> Proof:
    """Prove ``circuit_data`` under witness ``pw`` on the circuit's device
    (or ``device``).

    ``fused_sponge`` hashes every commitment through the one-launch sponge
    kernel instead of the chained permutation kernel; both give the same
    proof.  ``timings``, when given, receives seconds per phase (``tables``,
    ``witness``, ``commit_wires``, ``perm_columns``, ``quotient``, ``openings``,
    ``fri``) and per part of the two largest device phases (``quotient_perm``,
    ``quotient_gates``, ``quotient_finish``, ``quotient_commit``;
    ``fri_combine``, ``fri_initial``, ``fri_fold``, ``fri_grind``,
    ``fri_queries``), which add up to their phase."""
    pd = circuit_data.prover
    common = pd.common
    cfg = common.config
    n = common.n
    fri_cfg = cfg.fri
    lde_n = n * fri_cfg.blowup
    R = cfg.num_routed_wires
    C = cfg.num_challenges
    device = gl.resolve_device(device if device is not None else circuit_data.device)
    timer = _PhaseTimer(timings, device)
    timer.phase("tables")  # per-circuit tables, digest-cached across proofs
    kernels = get_circuit_kernels(pd, device)
    timer.phase("witness")

    # ---- 1. witness fill ----
    wires, public_inputs = compute_wire_matrix(pd, pw)
    pi_hash = ps.hash_no_pad_s(public_inputs)
    timer.phase("commit_wires")

    # ---- 2. commit wires ----
    wires_dev = gl.from_u64(wires, device)
    wire_coeffs_dev, wire_lde_dev, wires_tree = _commit(
        wires_dev, fri_cfg.rate_bits, fri_cfg.cap_height, fused_sponge=fused_sponge
    )

    challenger = Challenger()
    challenger.observe_hash(common.circuit_digest)
    challenger.observe_hash(pi_hash)
    challenger.observe_cap(_cap_tuples(wires_tree))
    betas = challenger.get_n_challenges(C)
    gammas = challenger.get_n_challenges(C)

    timer.phase("perm_columns")
    # ---- 3. permutation argument columns ----
    nch = n_chunks(R)
    betas_arr = _u64_tensor(betas, device)
    gammas_arr = _u64_tensor(gammas, device)
    z_cols_d, pp_cols_d, wraps = kernels["perm_columns"](wires_dev[:R], betas_arr, gammas_arr)
    zs_pp_matrix_dev = torch.cat([z_cols_d, pp_cols_d.reshape(C * (nch - 1), n)], dim=0)
    zspp_coeffs_dev, zspp_lde_dev, zs_pp_tree = _commit(
        zs_pp_matrix_dev, fri_cfg.rate_bits, fri_cfg.cap_height, fused_sponge=fused_sponge
    )
    assert (gl.to_u64(wraps) == 1).all(), (
        "permutation argument product != 1 (sigma inconsistent)"
    )
    challenger.observe_cap(_cap_tuples(zs_pp_tree))
    alphas = challenger.get_n_challenges(C)

    timer.phase("quotient", "quotient_perm")
    # ---- 4. quotient ----
    zs_lde_arr = zspp_lde_dev[:C]
    pps_lde_arr = zspp_lde_dev[C:].reshape(C, nch - 1, lde_n)
    alphas_arr = _u64_tensor(alphas, device)
    acc, apows = kernels["quotient_perm"](
        wire_lde_dev, zs_lde_arr, pps_lde_arr, betas_arr, gammas_arr, alphas_arr
    )
    timer.sub("quotient_gates")
    acc = kernels["quotient_gates"](
        wire_lde_dev, _u64_tensor(pi_hash, device), alphas_arr, acc, apows
    )
    timer.sub("quotient_finish")
    quotient_matrix_dev = kernels["quotient_finish"](acc)
    timer.sub("quotient_commit")
    quot_coeffs_dev, quot_lde_dev, quotient_tree = _commit(
        quotient_matrix_dev, fri_cfg.rate_bits, fri_cfg.cap_height, from_coeffs=True, fused_sponge=fused_sponge
    )
    challenger.observe_cap(_cap_tuples(quotient_tree))
    zeta = challenger.get_extension_challenge()

    timer.phase("openings")
    # ---- 5. openings at zeta (and g*zeta for Z columns) ----
    g_n = gl.primitive_root_of_unity(n.bit_length() - 1)
    zeta_arr = _u64_tensor(zeta, device)
    gzeta = (zeta[0] * g_n % P, zeta[1] * g_n % P)
    gzeta_arr = _u64_tensor(gzeta, device)

    all_coeffs_dev = torch.cat(
        [kernels["cs_coeffs_dev"], wire_coeffs_dev, zspp_coeffs_dev, quot_coeffs_dev], dim=0
    )
    opens_zeta, opens_gzeta_z = mk.fetch_arrays(
        _open_columns(all_coeffs_dev, zeta_arr),
        _open_columns(zspp_coeffs_dev[:C], gzeta_arr),
    )
    del all_coeffs_dev

    n_cs = pd.cs_coeffs.shape[0]
    n_w = cfg.num_wires
    n_zpp = zspp_coeffs_dev.shape[0]
    openings = {
        "constants_sigmas": [tuple(int(x) for x in o) for o in opens_zeta[:n_cs]],
        "wires": [tuple(int(x) for x in o) for o in opens_zeta[n_cs : n_cs + n_w]],
        "zs_pp": [tuple(int(x) for x in o) for o in opens_zeta[n_cs + n_w : n_cs + n_w + n_zpp]],
        "quotient": [tuple(int(x) for x in o) for o in opens_zeta[n_cs + n_w + n_zpp :]],
        "zs_next": [tuple(int(x) for x in o) for o in opens_gzeta_z],
    }
    for name in ["constants_sigmas", "wires", "zs_pp", "quotient", "zs_next"]:
        for o in openings[name]:
            challenger.observe_ext(o)

    timer.phase("fri", "fri_combine")
    # ---- 6. FRI ----
    alpha_fri = challenger.get_extension_challenge()

    # combine batch-1 columns (everything opened at zeta); LDEs are already
    # device-resident from _commit, constants ride on the per-circuit cache
    batch1_lde_dev = torch.cat(
        [kernels["cs_lde_dev"], wire_lde_dev, zspp_lde_dev, quot_lde_dev], dim=0
    )
    m1 = batch1_lde_dev.shape[0]
    alpha_pows = []
    apow = (1, 0)
    for _ in range(m1 + C):
        alpha_pows.append(apow)
        apow = ext_mul(apow, alpha_fri)

    comb1 = _combine_columns(batch1_lde_dev, _u64_tensor(alpha_pows[:m1], device))
    del batch1_lde_dev
    comb1_at_zeta = (0, 0)
    flat_opens = (
        openings["constants_sigmas"] + openings["wires"] + openings["zs_pp"] + openings["quotient"]
    )
    for i, y in enumerate(flat_opens):
        comb1_at_zeta = ext_add(comb1_at_zeta, ext_mul(alpha_pows[i], y))

    comb2 = _combine_columns(zspp_lde_dev[:C], _u64_tensor(alpha_pows[m1 : m1 + C], device))
    comb2_at_gzeta = (0, 0)
    for j, y in enumerate(openings["zs_next"]):
        comb2_at_gzeta = ext_add(comb2_at_gzeta, ext_mul(alpha_pows[m1 + j], y))

    timer.sub("fri_initial")
    # FRI initial quotient G(x) on the cached coset table
    scalars = _u64_tensor([zeta, gzeta, comb1_at_zeta, comb2_at_gzeta], device)  # [4, 2]
    G = fi.fri_initial_cuda(
        comb1[None], comb2[None], kernels["xs"],
        scalars[0:1], scalars[1:2], scalars[2:3], scalars[3:4],
    )[0]

    timer.sub("fri_fold")
    trees, final_poly, fri_betas = fold_layers(
        G, gl.MULTIPLICATIVE_GROUP_GENERATOR, fri_cfg, challenger, fused_sponge=fused_sponge
    )
    timer.sub("fri_grind")
    pow_witness = grind_pow(challenger, fri_cfg.proof_of_work_bits, device, fused_sponge=fused_sponge)
    timer.sub("fri_queries")
    indices, rounds = query_rounds(trees, fri_cfg, challenger, lde_n)

    # initial-tree openings per query: device trees gather only the touched
    # leaf rows + path digests (one combined small fetch); the
    # constants_sigmas tree of the built circuit is host numpy
    named_trees = {
        "constants_sigmas": (None, pd.cs_lde, pd.cs_tree),
        "wires": (wire_lde_dev, None, wires_tree),
        "zs_pp": (zspp_lde_dev, None, zs_pp_tree),
        "quotient": (quot_lde_dev, None, quotient_tree),
    }
    initial_openings = _extract_initial_openings(named_trees, indices)

    fri_proof = FriProof(
        caps=[_cap_tuples(t) for t in trees],
        final_poly=final_poly,
        pow_witness=pow_witness,
        query_rounds=rounds,
    )

    timer.phase("_end")
    return Proof(
        wires_cap=_cap_tuples(wires_tree),
        zs_pp_cap=_cap_tuples(zs_pp_tree),
        quotient_cap=_cap_tuples(quotient_tree),
        openings=openings,
        fri=fri_proof,
        initial_openings=initial_openings,
        public_inputs=[int(v) for v in public_inputs],
    )
