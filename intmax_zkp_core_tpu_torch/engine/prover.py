"""The Plonk-style prover: witness fill -> wire commitment -> permutation
argument -> quotient -> FRI opening proof.

This is the counterpart of ``CircuitData::prove``.  ``prove_batch`` proves
K witnesses of one circuit in one device pass and ``prove`` is it at K = 1:
every device phase runs over a leading proof axis K -- each kernel is called
once per phase for all K proofs -- while each proof keeps its own host
transcript (``engine/challenger.py``), observed and sampled in exactly the
order of a single proof, so the K proofs are bit-identical to K ``prove``
calls.  Per phase: the witness fill runs K times on the host into one
[K, W, n] array; every iNTT and coset LDE folds the proof axis into the rows
(one ``ntt_cuda`` call over K * S rows); the Merkle levels of the K trees of
a commitment are hashed one call per level
(``ops/merkle.py::device_merkle_trees_batch``); the FRI layers of the K
proofs fold in lockstep.  The grind and the query rounds stay per proof, as
each needs its own transcript's state.

All polynomial work is batched tensor code on the device; on the
host, the witness fill runs in C++ (``native/witness_native.cpp``) and the
Fiat-Shamir transcript through the host C++ permutation, and Python only
orchestrates.  When the circuit lives on the card, every NTT runs
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
    constraints of one gate type onto the running quotient numerators of K
    proofs:

        acc'[k, c] = acc[k, c] + sum_i alphas[k, c]^i * sel * constraint_i
        apows'[k, c] = apows[k, c] * alphas[k, c]^num_constraints

    ``wires_lde`` [K, W, lde_n], ``sel_col`` [lde_n], ``const_cols``
    [n_const, lde_n] (the circuit's, shared), ``pi_hash`` [K, 4] and
    ``alphas`` [K, C] (each proof's), ``acc`` [K, C, lde_n], ``apows`` [K, C].
    """
    gate = GATE_TYPES[gate_id]

    def run(wires_lde, sel_col, const_cols, pi_hash, alphas, acc, apows):
        alg = BatchAlgebra()
        wires_cols = [wires_lde[:, i] for i in range(num_wires)]
        ccols = [const_cols[i] for i in range(n_const)]
        pi_cols = [pi_hash[:, i : i + 1] for i in range(4)]
        batched = getattr(gate, "eval_constraints_batched", None)
        if batched is not None:
            cs = batched(wires_cols, ccols, pi_cols)
        else:
            cs = gate.eval_constraints(alg, wires_cols, ccols, pi_cols)
        out_acc = [acc[:, c] for c in range(C)]
        out_apows = [apows[:, c : c + 1] for c in range(C)]
        for t in cs:
            filt = gl.mul(sel_col, t)
            for c in range(C):
                out_acc[c] = gl.add(out_acc[c], gl.mul(out_apows[c], filt))
                out_apows[c] = gl.mul(out_apows[c], alphas[:, c : c + 1])
        return torch.stack(out_acc, dim=1), torch.cat(out_apows, dim=1)

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


def _open_columns(coeffs: torch.Tensor, zetas: torch.Tensor) -> torch.Tensor:
    """Evaluate K proofs' S column polynomials [K, S, n] at each proof's
    extension point ``zetas`` [K, 2]; returns [K, S, 2].

    Log-depth even/odd folding instead of an n-step Horner scan:
    ``p(z) = E(z^2) + z * O(z^2)`` halves the coefficient count per fold.
    All arithmetic is exact mod p, so the result is bit-identical to
    Horner."""
    K, S, n = coeffs.shape
    if n & (n - 1) != 0:
        raise ValueError(f"column length must be a power of two, got {n}")
    cur = torch.stack([coeffs, torch.zeros_like(coeffs)], dim=-1)  # [K, S, n, 2]
    z = zetas[:, None, None, :]  # [K, 1, 1, 2], then z^2, z^4, ... per fold
    while cur.shape[2] > 1:
        pairs = cur.reshape(K, S, cur.shape[2] // 2, 2, 2)
        even = pairs[:, :, :, 0]
        odd = pairs[:, :, :, 1]
        cur = gl.ext_add(even, gl.ext_mul(odd, z.expand(odd.shape)))
        z = gl.ext_mul(z, z)
    return cur[:, :, 0]


def _tree_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over the rows of [..., m, L] mod p in a log-depth halving tree."""
    m = t.shape[-2]
    mp = 1 << max(m - 1, 0).bit_length()
    if mp != m:
        pad = torch.zeros(t.shape[:-2] + (mp - m, t.shape[-1]), dtype=torch.int64, device=t.device)
        t = torch.cat([t, pad], dim=-2)
    while t.shape[-2] > 1:
        half = t.shape[-2] // 2
        t = gl.add(t[..., :half, :], t[..., half:, :])
    return t[..., 0, :]


def _combine_columns(lde_matrix: torch.Tensor, pows_arr: torch.Tensor) -> torch.Tensor:
    """sum_i alpha^i * p_i(X) for K proofs: base-field columns [K, m, lde_n]
    times each proof's extension alpha powers [K, m, 2] -> [K, lde_n, 2].

    Rows are taken ``COMBINE_ROW_BLOCK`` at a time so the temporaries of the
    weighted terms stay small; modular addition is associative and exact, so
    the sum does not depend on the grouping."""
    K, m, lde_n = lde_matrix.shape
    acc0 = torch.zeros((K, lde_n), dtype=torch.int64, device=lde_matrix.device)
    acc1 = torch.zeros_like(acc0)
    for lo in range(0, m, COMBINE_ROW_BLOCK):
        block = lde_matrix[:, lo : lo + COMBINE_ROW_BLOCK]
        pw = pows_arr[:, lo : lo + COMBINE_ROW_BLOCK]
        acc0 = gl.add(acc0, _tree_sum(gl.mul(block, pw[:, :, 0:1])))
        acc1 = gl.add(acc1, _tree_sum(gl.mul(block, pw[:, :, 1:2])))
    return torch.stack([acc0, acc1], dim=-1)  # [K, lde_n, 2]


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
        """wires [K, >= R, n] (the first R rows are read); betas/gammas [K, C]
        -> (z_cols [K, C, n], pp [K, C, nch-1, n], wrap [K, C] which must be
        all-ones)."""
        return pcol.perm_columns_cuda(wires, betas, gammas, id_vals_c, sigma_c)

    # The alpha-power ordering [L_0 term, permutation chunks, every gate's
    # constraints in gate order] is identical to the verifier's.

    def quotient_perm(wires_lde, zs_lde, pps_lde, betas, gammas, alphas):
        """-> (acc [K, C, lde_n], apows [K, C]): the L_0 + permutation-chunk
        terms alpha-combined, and the alpha power reached per challenge."""
        return pq.perm_quotient_cuda(
            wires_lde, zs_lde, pps_lde, betas, gammas, alphas, sigma_lde_c, xs_c, l0_c, k_is_c,
            blowup,
        )

    def quotient_finish(acc):
        """acc [K, C, lde_n] -> quotient coefficient chunks [K, C*blowup, n]:
        the divide by Z_H, then iNTT and coset unshift."""
        q_evals = zm.zinv_mul_cuda(acc, z_h_c)
        return gl.mul(nt.intt(q_evals), shift_pows_c).reshape(acc.shape[0], C * blowup, n)

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
        """acc [K, C, lde_n] plus every gate's selector-filtered constraints,
        alpha-combined from the powers ``apows`` [K, C] on, gate by gate in
        the verifier's order."""
        for gi, fn in gate_chunks:
            if fn is None:
                acc, apows = gqc.poseidon_gate_quotient_cuda(
                    wires_lde, sel_cols[gi], alphas, acc, apows)
            else:
                acc, apows = fn(
                    wires_lde, sel_cols[gi], const_lde, pi_hash, alphas, acc, apows
                )
        return acc

    kernels = {
        "perm_columns": perm_columns,
        # the quotient in its three parts, over K proofs: wires_lde [K, W,
        # lde_n], zs_lde [K, C, lde_n], pps_lde [K, C, nch-1, lde_n],
        # challenges [K, C], pi_hash [K, 4] -> quotient coefficient chunks
        # [K, C*blowup, n]
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


class PhaseTimer:
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


def _commit_batch(matrices, rate_bits: int, cap_height: int, from_coeffs: bool = False,
                  fused_sponge: bool = False):
    """Columns [K, S, n] on the device (evaluations on the subgroup, or
    coefficients if ``from_coeffs``) -> (coeffs [K, S, n], lde [K, S, lde_n],
    K trees).

    The NTTs fold the proof axis into the rows (one call each); the K trees
    are built in one pass, their levels stay on the device (each tree a
    ``DeviceMerkleTree`` of views) and only the caps are fetched.  The
    leaves are the columns of each proof's LDE: the builder gets the
    transposed view."""
    coeffs = matrices if from_coeffs else nt.intt(matrices)
    lde = nt.coset_lde(coeffs, rate_bits)
    trees = mk.device_merkle_trees_batch(lde.transpose(1, 2), cap_height, fused_sponge=fused_sponge)
    return coeffs, lde, trees


def _openings_dict(opens_zeta, opens_gzeta_z, n_cs: int, n_w: int, n_zpp: int) -> dict:
    """One proof's openings at zeta [m, 2] and g*zeta [C, 2] as the proof's
    named lists of (c0, c1) tuples."""
    rows = lambda a: [tuple(int(x) for x in o) for o in a]  # noqa: E731
    return {
        "constants_sigmas": rows(opens_zeta[:n_cs]),
        "wires": rows(opens_zeta[n_cs : n_cs + n_w]),
        "zs_pp": rows(opens_zeta[n_cs + n_w : n_cs + n_w + n_zpp]),
        "quotient": rows(opens_zeta[n_cs + n_w + n_zpp :]),
        "zs_next": rows(opens_gzeta_z),
    }


def prove_batch(
    circuit_data: CircuitData,
    pws: list,
    device=None,
    fused_sponge: bool = False,
    timings: dict | None = None,
) -> list:
    """Prove K witnesses ``pws`` of one circuit on the circuit's device (or
    ``device``); returns K proofs bit-identical to K ``prove`` calls.

    ``fused_sponge`` and ``timings`` are those of ``prove``: the phases are
    timed for the batch as a whole."""
    pd = circuit_data.prover
    common = pd.common
    cfg = common.config
    n = common.n
    fri_cfg = cfg.fri
    lde_n = n * fri_cfg.blowup
    R = cfg.num_routed_wires
    C = cfg.num_challenges
    nch = n_chunks(R)
    K = len(pws)
    if K < 1:
        raise ValueError("prove_batch wants at least one witness")
    device = gl.resolve_device(device if device is not None else circuit_data.device)
    timer = PhaseTimer(timings, device)
    timer.phase("tables")  # per-circuit tables, digest-cached across proofs
    kernels = get_circuit_kernels(pd, device)
    timer.phase("witness")

    # ---- 1. witness fill (host, per proof) ----
    wires_all = np.empty((K, cfg.num_wires, n), dtype=np.uint64)
    public_inputs_all, pi_hashes = [], []
    for k, pw in enumerate(pws):
        wires_all[k], public_inputs = compute_wire_matrix(pd, pw)
        public_inputs_all.append(public_inputs)
        pi_hashes.append(ps.hash_no_pad_s(public_inputs))
    timer.phase("commit_wires")

    # ---- 2. commit wires ----
    wires_dev = gl.from_u64(wires_all, device)
    wire_coeffs_dev, wire_lde_dev, wires_trees = _commit_batch(
        wires_dev, fri_cfg.rate_bits, fri_cfg.cap_height, fused_sponge=fused_sponge
    )
    challengers = [Challenger() for _ in range(K)]
    betas, gammas = [], []
    for k, ch in enumerate(challengers):
        ch.observe_hash(common.circuit_digest)
        ch.observe_hash(pi_hashes[k])
        ch.observe_cap(_cap_tuples(wires_trees[k]))
        betas.append(ch.get_n_challenges(C))
        gammas.append(ch.get_n_challenges(C))

    timer.phase("perm_columns")
    # ---- 3. permutation argument columns ----
    betas_arr = _u64_tensor(betas, device)  # [K, C]
    gammas_arr = _u64_tensor(gammas, device)
    z_cols_d, pp_cols_d, wraps = kernels["perm_columns"](wires_dev, betas_arr, gammas_arr)
    zs_pp_dev = torch.cat([z_cols_d, pp_cols_d.reshape(K, C * (nch - 1), n)], dim=1)
    zspp_coeffs_dev, zspp_lde_dev, zs_pp_trees = _commit_batch(
        zs_pp_dev, fri_cfg.rate_bits, fri_cfg.cap_height, fused_sponge=fused_sponge
    )
    assert (gl.to_u64(wraps) == 1).all(), (
        "permutation argument product != 1 (sigma inconsistent)"
    )
    alphas = []
    for k, ch in enumerate(challengers):
        ch.observe_cap(_cap_tuples(zs_pp_trees[k]))
        alphas.append(ch.get_n_challenges(C))

    timer.phase("quotient", "quotient_perm")
    # ---- 4. quotient ----
    # the kernels read the Z and partial-product rows as dense [K, C, ...]
    # blocks: slices of the [K, S, lde_n] LDE are copied once K > 1
    zs_lde_arr = zspp_lde_dev[:, :C].contiguous()
    pps_lde_arr = zspp_lde_dev[:, C:].reshape(K, C, nch - 1, lde_n).contiguous()
    alphas_arr = _u64_tensor(alphas, device)
    acc, apows = kernels["quotient_perm"](
        wire_lde_dev, zs_lde_arr, pps_lde_arr, betas_arr, gammas_arr, alphas_arr
    )
    del zs_lde_arr, pps_lde_arr
    timer.sub("quotient_gates")
    acc = kernels["quotient_gates"](
        wire_lde_dev, _u64_tensor(pi_hashes, device), alphas_arr, acc, apows
    )
    timer.sub("quotient_finish")
    quotient_dev = kernels["quotient_finish"](acc)
    timer.sub("quotient_commit")
    quot_coeffs_dev, quot_lde_dev, quotient_trees = _commit_batch(
        quotient_dev, fri_cfg.rate_bits, fri_cfg.cap_height, from_coeffs=True,
        fused_sponge=fused_sponge,
    )
    zetas = []
    for k, ch in enumerate(challengers):
        ch.observe_cap(_cap_tuples(quotient_trees[k]))
        zetas.append(ch.get_extension_challenge())

    timer.phase("openings")
    # ---- 5. openings at zeta (and g*zeta for Z columns) ----
    g_n = gl.primitive_root_of_unity(n.bit_length() - 1)
    gzetas = [(z[0] * g_n % P, z[1] * g_n % P) for z in zetas]
    zetas_arr = _u64_tensor(zetas, device)  # [K, 2]
    gzetas_arr = _u64_tensor(gzetas, device)
    cs_coeffs = kernels["cs_coeffs_dev"]
    all_coeffs_dev = torch.cat(
        [cs_coeffs.expand((K,) + cs_coeffs.shape), wire_coeffs_dev, zspp_coeffs_dev,
         quot_coeffs_dev], dim=1,
    )
    opens_zeta, opens_gzeta_z = mk.fetch_arrays(
        _open_columns(all_coeffs_dev, zetas_arr),
        _open_columns(zspp_coeffs_dev[:, :C], gzetas_arr),
    )
    del all_coeffs_dev
    sizes = (pd.cs_coeffs.shape[0], cfg.num_wires, zspp_coeffs_dev.shape[1])
    openings_all = []
    for k, ch in enumerate(challengers):
        openings = _openings_dict(opens_zeta[k], opens_gzeta_z[k], *sizes)
        for name in ["constants_sigmas", "wires", "zs_pp", "quotient", "zs_next"]:
            for o in openings[name]:
                ch.observe_ext(o)
        openings_all.append(openings)

    timer.phase("fri", "fri_combine")
    # ---- 6. FRI ----
    alpha_fris = [ch.get_extension_challenge() for ch in challengers]
    # combine batch-1 columns (everything opened at zeta); LDEs are already
    # device-resident from the commitments, constants ride on the circuit's
    # tables
    cs_lde = kernels["cs_lde_dev"]
    batch1_lde_dev = torch.cat(
        [cs_lde.expand((K,) + cs_lde.shape), wire_lde_dev, zspp_lde_dev, quot_lde_dev], dim=1
    )
    m1 = batch1_lde_dev.shape[1]
    alpha_pows = []  # per proof: alpha^0 .. alpha^(m1 + C - 1)
    for alpha_fri in alpha_fris:
        pows, apow = [], (1, 0)
        for _ in range(m1 + C):
            pows.append(apow)
            apow = ext_mul(apow, alpha_fri)
        alpha_pows.append(pows)
    pows_arr = _u64_tensor(alpha_pows, device)  # [K, m1 + C, 2]

    comb1 = _combine_columns(batch1_lde_dev, pows_arr[:, :m1])
    del batch1_lde_dev
    comb2 = _combine_columns(zspp_lde_dev[:, :C], pows_arr[:, m1:])
    comb1_at_zeta, comb2_at_gzeta = [], []
    for k, openings in enumerate(openings_all):
        flat_opens = (
            openings["constants_sigmas"] + openings["wires"] + openings["zs_pp"]
            + openings["quotient"]
        )
        acc1 = (0, 0)
        for i, y in enumerate(flat_opens):
            acc1 = ext_add(acc1, ext_mul(alpha_pows[k][i], y))
        acc2 = (0, 0)
        for j, y in enumerate(openings["zs_next"]):
            acc2 = ext_add(acc2, ext_mul(alpha_pows[k][m1 + j], y))
        comb1_at_zeta.append(acc1)
        comb2_at_gzeta.append(acc2)

    timer.sub("fri_initial")
    # FRI initial quotient G(x) on the cached coset table
    G = fi.fri_initial_cuda(
        comb1, comb2, kernels["xs"], zetas_arr, gzetas_arr,
        _u64_tensor(comb1_at_zeta, device), _u64_tensor(comb2_at_gzeta, device),
    )

    timer.sub("fri_fold")
    fri_trees, final_polys = fold_layers(
        G, gl.MULTIPLICATIVE_GROUP_GENERATOR, fri_cfg, challengers, fused_sponge=fused_sponge
    )
    timer.sub("fri_grind")
    pow_witnesses = [
        grind_pow(ch, fri_cfg.proof_of_work_bits, device, fused_sponge=fused_sponge)
        for ch in challengers
    ]
    timer.sub("fri_queries")
    proofs = []
    for k, ch in enumerate(challengers):
        indices, rounds = query_rounds(fri_trees[k], fri_cfg, ch, lde_n)
        # initial-tree openings per query: each proof's device trees gather
        # only the touched leaf rows of its LDE and path digests (one small
        # fetch); the constants_sigmas tree of the built circuit is host numpy
        named_trees = {
            "constants_sigmas": (None, pd.cs_lde, pd.cs_tree),
            "wires": (wire_lde_dev[k], None, wires_trees[k]),
            "zs_pp": (zspp_lde_dev[k], None, zs_pp_trees[k]),
            "quotient": (quot_lde_dev[k], None, quotient_trees[k]),
        }
        proofs.append(Proof(
            wires_cap=_cap_tuples(wires_trees[k]),
            zs_pp_cap=_cap_tuples(zs_pp_trees[k]),
            quotient_cap=_cap_tuples(quotient_trees[k]),
            openings=openings_all[k],
            fri=FriProof(
                caps=[_cap_tuples(t) for t in fri_trees[k]],
                final_poly=final_polys[k],
                pow_witness=pow_witnesses[k],
                query_rounds=rounds,
            ),
            initial_openings=_extract_initial_openings(named_trees, indices),
            public_inputs=[int(v) for v in public_inputs_all[k]],
        ))
    timer.phase("_end")
    return proofs


def prove(
    circuit_data: CircuitData,
    pw: PartialWitness,
    device=None,
    fused_sponge: bool = False,
    timings: dict | None = None,
) -> Proof:
    """Prove ``circuit_data`` under witness ``pw`` on the circuit's device
    (or ``device``): ``prove_batch`` at K = 1.

    ``fused_sponge`` hashes every commitment through the one-launch sponge
    kernel instead of the chained permutation kernel; both give the same
    proof.  ``timings``, when given, receives seconds per phase (``tables``,
    ``witness``, ``commit_wires``, ``perm_columns``, ``quotient``, ``openings``,
    ``fri``) and per part of the two largest device phases (``quotient_perm``,
    ``quotient_gates``, ``quotient_finish``, ``quotient_commit``;
    ``fri_combine``, ``fri_initial``, ``fri_fold``, ``fri_grind``,
    ``fri_queries``), which add up to their phase."""
    return prove_batch(circuit_data, [pw], device, fused_sponge, timings)[0]
