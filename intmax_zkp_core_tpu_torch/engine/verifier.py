"""Proof verification (counterpart of ``CircuitData::verify``).

Pure host code, exact integer arithmetic: replay the transcript, check the
vanishing/quotient identity at zeta with the same single-sourced gate
evaluators (in ExtAlgebra mode), and verify the FRI opening proof.
"""

from __future__ import annotations

import numpy as np

from ..ops import goldilocks as gl
from ..ops import merkle as mk
from ..ops import poseidon as ps
from .algebra import ExtAlgebra, ext_add, ext_inv, ext_mul, ext_pow, ext_sub
from .challenger import Challenger
from .circuit import CommonCircuitData
from .fri import verify_fri
from .gates import GATE_TYPES
from .prover import CHUNK, Proof, n_chunks

P = gl.P_INT


def verify(common: CommonCircuitData, proof: Proof) -> None:
    cfg = common.config
    fri_cfg = cfg.fri
    n = common.n
    lde_n = n * fri_cfg.blowup
    R = cfg.num_routed_wires
    nch = n_chunks(R)

    assert len(proof.public_inputs) == common.num_public_inputs, "bad public input count"
    pi_hash = ps.hash_no_pad_s([v % P for v in proof.public_inputs])

    # ---- transcript replay ----
    challenger = Challenger()
    challenger.observe_hash(common.circuit_digest)
    challenger.observe_hash(pi_hash)
    challenger.observe_cap(proof.wires_cap)
    betas = challenger.get_n_challenges(cfg.num_challenges)
    gammas = challenger.get_n_challenges(cfg.num_challenges)
    challenger.observe_cap(proof.zs_pp_cap)
    alphas = challenger.get_n_challenges(cfg.num_challenges)
    challenger.observe_cap(proof.quotient_cap)
    zeta = challenger.get_extension_challenge()
    for name in ["constants_sigmas", "wires", "zs_pp", "quotient", "zs_next"]:
        for o in proof.openings[name]:
            challenger.observe_ext(o)
    alpha_fri = challenger.get_extension_challenge()

    # ---- vanishing / quotient identity at zeta ----
    alg = ExtAlgebra()
    ops = proof.openings
    n_sel = common.n_sel
    sel = ops["constants_sigmas"][:n_sel]
    consts = ops["constants_sigmas"][n_sel : n_sel + common.n_const_cols]
    sigmas_z = ops["constants_sigmas"][n_sel + common.n_const_cols :]
    wires_z = ops["wires"]
    zs_z = ops["zs_pp"][: cfg.num_challenges]
    pps_z = [
        ops["zs_pp"][cfg.num_challenges + c * (nch - 1) : cfg.num_challenges + (c + 1) * (nch - 1)]
        for c in range(cfg.num_challenges)
    ]
    zs_next = ops["zs_next"]
    quot_z = [
        ops["quotient"][c * fri_cfg.blowup : (c + 1) * fri_cfg.blowup]
        for c in range(cfg.num_challenges)
    ]

    pi_hash_ext = [(v, 0) for v in pi_hash]
    gate_constraint_vals = []
    for gi, gate_id in enumerate(common.gate_ids):
        gate = GATE_TYPES[gate_id]
        if gate.num_constraints == 0:
            continue
        cs = gate.eval_constraints(alg, wires_z, consts, pi_hash_ext)
        gate_constraint_vals.extend(ext_mul(sel[gi], c) for c in cs)

    zeta_n = ext_pow(zeta, n)
    z_h_zeta = ext_sub(zeta_n, (1, 0))
    # L_0(zeta) = (zeta^n - 1) / (n * (zeta - 1))
    l0 = ext_mul(z_h_zeta, ext_inv(ext_mul((n, 0), ext_sub(zeta, (1, 0)))))

    for c in range(cfg.num_challenges):
        beta, gamma = betas[c], gammas[c]
        terms = [ext_mul(l0, ext_sub(zs_z[c], (1, 0)))]
        prev = zs_z[c]
        for j in range(nch):
            lo, hi = j * CHUNK, min((j + 1) * CHUNK, R)
            f = (1, 0)
            g = (1, 0)
            for i in range(lo, hi):
                v = wires_z[i]
                idv = ext_mul((common.k_is[i] * beta % P, 0), zeta)
                f = ext_mul(f, ext_add(ext_add(v, idv), (gamma, 0)))
                g = ext_mul(
                    g, ext_add(ext_add(v, ext_mul((beta, 0), sigmas_z[i])), (gamma, 0))
                )
            nxt = zs_next[c] if j == nch - 1 else pps_z[c][j]
            terms.append(ext_sub(ext_mul(nxt, g), ext_mul(prev, f)))
            if j < nch - 1:
                prev = pps_z[c][j]
        terms.extend(gate_constraint_vals)

        vanishing = (0, 0)
        apow = (1, 0)
        for t in terms:
            vanishing = ext_add(vanishing, ext_mul(apow, t))
            apow = ext_mul(apow, (alphas[c], 0))

        # quotient recombination: q(zeta) = sum_i zeta^(n*i) * chunk_i(zeta)
        q = (0, 0)
        zpow = (1, 0)
        for i in range(fri_cfg.blowup):
            q = ext_add(q, ext_mul(zpow, quot_z[c][i]))
            zpow = ext_mul(zpow, zeta_n)
        assert vanishing == ext_mul(z_h_zeta, q), f"vanishing/quotient mismatch (challenge {c})"

    # ---- FRI ----
    g_n = gl.primitive_root_of_unity(n.bit_length() - 1)
    gzeta = (zeta[0] * g_n % P, zeta[1] * g_n % P)

    flat_opens = ops["constants_sigmas"] + ops["wires"] + ops["zs_pp"] + ops["quotient"]
    m1 = len(flat_opens)
    alpha_pows = []
    apow = (1, 0)
    for _ in range(m1 + cfg.num_challenges):
        alpha_pows.append(apow)
        apow = ext_mul(apow, alpha_fri)
    comb1_at_zeta = (0, 0)
    for i, y in enumerate(flat_opens):
        comb1_at_zeta = ext_add(comb1_at_zeta, ext_mul(alpha_pows[i], y))
    comb2_at_gzeta = (0, 0)
    for j, y in enumerate(ops["zs_next"]):
        comb2_at_gzeta = ext_add(comb2_at_gzeta, ext_mul(alpha_pows[m1 + j], y))

    caps = {
        "constants_sigmas": np.array(common.constants_sigmas_cap, dtype=np.uint64),
        "wires": np.array(proof.wires_cap, dtype=np.uint64),
        "zs_pp": np.array(proof.zs_pp_cap, dtype=np.uint64),
        "quotient": np.array(proof.quotient_cap, dtype=np.uint64),
    }
    w_lde = gl.primitive_root_of_unity(lde_n.bit_length() - 1)
    query_counter = [0]

    def eval_initial(idx: int):
        per = proof.initial_openings[query_counter[0]]
        query_counter[0] += 1
        x = gl.MULTIPLICATIVE_GROUP_GENERATOR * pow(w_lde, idx, P) % P
        values = []
        for name in ["constants_sigmas", "wires", "zs_pp", "quotient"]:
            leaf, path = per[name]
            assert mk.verify_merkle_proof(leaf, idx, path, caps[name]), (
                f"initial tree {name} merkle check failed"
            )
            values.extend((int(v), 0) for v in leaf)
        comb1 = (0, 0)
        for i, y in enumerate(values):
            comb1 = ext_add(comb1, ext_mul(alpha_pows[i], y))
        n_cs = len(ops["constants_sigmas"])
        n_w = len(ops["wires"])
        zs_leaf = per["zs_pp"][0]
        comb2 = (0, 0)
        for j in range(cfg.num_challenges):
            comb2 = ext_add(comb2, ext_mul(alpha_pows[m1 + j], (int(zs_leaf[j]), 0)))
        t1 = ext_mul(ext_sub(comb1, comb1_at_zeta), ext_inv(ext_sub((x, 0), zeta)))
        t2 = ext_mul(ext_sub(comb2, comb2_at_gzeta), ext_inv(ext_sub((x, 0), gzeta)))
        return ext_add(t1, t2)

    verify_fri(
        proof.fri,
        challenger,
        fri_cfg,
        lde_n,
        gl.MULTIPLICATIVE_GROUP_GENERATOR,
        eval_initial,
    )
