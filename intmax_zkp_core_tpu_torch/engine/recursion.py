"""In-circuit verification of this engine's proofs — the recursion core
(the plonky2 capability behind ``builder.verify_proof`` that the reference
relies on at ``recursion/gadgets/mod.rs:103``).

The gadget replays the host verifier (``engine/verifier.py``) inside a
circuit:

* a Poseidon duplex challenger over proof targets (identical buffering);
* the vanishing/quotient identity at zeta, evaluating the same single-
  sourced gate constraints through an extension-target algebra;
* the FRI opening proof: initial-tree Merkle openings, per-layer fold
  consistency, final-polynomial evaluation, and the grinding check, with
  query indices derived in-circuit from transcript challenges.

Everything is static at build time (layer sizes, query counts, opening
widths come from the inner circuit's CommonCircuitData); only values are
witnesses.  The gadget is host Python: it emits gates and generator records
and runs no kernel; the outer circuit proves through the same prover as any
other.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..ops import goldilocks as glh
from ..ops.goldilocks import P_INT as P
from .challenger import RATE, WIDTH
from .circuit import BoolTarget, CircuitBuilder, HashOutTarget
from .config import CircuitConfig
from .gates import GATE_TYPES
from .prover import CHUNK, n_chunks

W_EXT = 7  # x^2 - 7


# ---------------------------------------------------------------------------
# extension-field arithmetic over target pairs
# ---------------------------------------------------------------------------


class ExtTargetAlgebra:
    """Values are (t0, t1) target pairs; emits arithmetic gates."""

    def __init__(self, builder: CircuitBuilder):
        self.b = builder

    def const(self, c: int):
        return (self.b.constant(c % P), self.b.zero())

    def from_base_target(self, t):
        return (t, self.b.zero())

    def add(self, x, y):
        return (self.b.add(x[0], y[0]), self.b.add(x[1], y[1]))

    def sub(self, x, y):
        return (self.b.sub(x[0], y[0]), self.b.sub(x[1], y[1]))

    def mul(self, x, y):
        # c0 = x0 y0 + 7 x1 y1 ; c1 = x0 y1 + x1 y0
        x0y0 = self.b.mul(x[0], y[0])
        c0 = self.b.arithmetic(W_EXT, 1, x[1], y[1], x0y0)
        x0y1 = self.b.mul(x[0], y[1])
        c1 = self.b.arithmetic(1, 1, x[1], y[0], x0y1)
        return (c0, c1)

    def add_const(self, x, c: int):
        one = self.b.one()
        return (self.b.arithmetic(c % P, 1, one, one, x[0]), x[1])

    def mul_const(self, x, c: int):
        c = c % P
        return (self.b.mul_const(c, x[0]), self.b.mul_const(c, x[1]))

    def mul_base(self, x, t):
        """ext * base-target."""
        return (self.b.mul(x[0], t), self.b.mul(x[1], t))

    def exp7(self, x):
        x2 = self.mul(x, x)
        x3 = self.mul(x2, x)
        return self.mul(self.mul(x3, x3), x)

    def inverse(self, x):
        """Witnessed inverse with x * xinv == 1 enforced."""
        b = self.b
        inv0 = b.add_virtual_target()
        inv1 = b.add_virtual_target()
        b.generators.append(("ext_inverse", x[0], x[1], inv0, inv1, W_EXT))
        prod = self.mul(x, (inv0, inv1))
        b.assert_one(prod[0])
        b.assert_zero(prod[1])
        return (inv0, inv1)

    def div(self, x, y):
        return self.mul(x, self.inverse(y))

    def select(self, flag: BoolTarget, x, y):
        return (self.b.select(flag, x[0], y[0]), self.b.select(flag, x[1], y[1]))

    def zero(self):
        z = self.b.zero()
        return (z, z)

    def one(self):
        return (self.b.one(), self.b.zero())


# ---------------------------------------------------------------------------
# in-circuit challenger (duplex sponge, host-identical buffering)
# ---------------------------------------------------------------------------


class ChallengerTarget:
    def __init__(self, builder: CircuitBuilder):
        self.b = builder
        zero = builder.zero()
        self.state = [zero] * WIDTH
        self.input_buffer: list = []
        self.output_buffer: list = []

    def observe_element(self, t) -> None:
        self.input_buffer.append(t)
        if len(self.input_buffer) == RATE:
            self._duplex()

    def observe_elements(self, ts) -> None:
        for t in ts:
            self.observe_element(t)

    def observe_hash(self, h) -> None:
        self.observe_elements(list(h))

    def observe_cap(self, cap) -> None:
        for digest in cap:
            self.observe_hash(digest)

    def observe_ext(self, e) -> None:
        self.observe_elements([e[0], e[1]])

    def _duplex(self) -> None:
        state = list(self.state)
        for i, t in enumerate(self.input_buffer):
            state[i] = t
        self.input_buffer = []
        self.state = self.b.poseidon_permute(state)
        self.output_buffer = list(self.state[:RATE])

    def get_challenge(self):
        if self.input_buffer or not self.output_buffer:
            self._duplex()
        return self.output_buffer.pop()

    def get_n_challenges(self, n: int):
        return [self.get_challenge() for _ in range(n)]

    def get_extension_challenge(self):
        a = self.get_challenge()
        b = self.get_challenge()
        return (a, b)


# ---------------------------------------------------------------------------
# proof target structure
# ---------------------------------------------------------------------------


@dataclass
class ProofTarget:
    wires_cap: list
    zs_pp_cap: list
    quotient_cap: list
    openings: dict  # name -> list of ext target pairs
    fri_caps: list  # per layer: list of HashOutTarget
    final_poly: list  # ext target pairs
    pow_witness: int  # target
    # per query: {name: leaf targets}; fri layers: per query per layer
    # (leaf 4 targets, path list of HashOutTarget)
    initial_leaves: list
    initial_paths: list
    fri_leaves: list
    fri_paths: list
    public_inputs: list


def _select_digest(builder, bits, digests):
    """Multiplexer: select digests[idx] where idx = sum bits[j] 2^j."""
    layer = list(digests)
    for bit in bits:
        nxt = []
        for i in range(0, len(layer), 2):
            nxt.append(builder.select_hash(bit, layer[i + 1], layer[i]))
        layer = nxt
    assert len(layer) == 1
    return layer[0]


def _pow_from_bits(builder, bits, base: int):
    """Compute base^(sum bits[j] 2^j) as a base-field target."""
    acc = builder.one()
    cur = base % P
    for bit in bits:
        factor = builder.select(bit, builder.constant(cur), builder.one())
        acc = builder.mul(acc, factor)
        cur = cur * cur % P
    return acc


def add_virtual_proof_target(builder: CircuitBuilder, common) -> ProofTarget:
    """Allocate all proof targets for an inner circuit described by
    ``common`` (CommonCircuitData)."""
    cfg: CircuitConfig = common.config
    fri = cfg.fri
    n = common.n
    lde_n = n * fri.blowup
    cap_size = 1 << fri.cap_height
    nch = n_chunks(cfg.num_routed_wires)
    n_cs_cols = common.n_sel + common.n_const_cols + cfg.num_routed_wires
    n_zpp = cfg.num_challenges * nch
    n_quot = cfg.num_challenges * fri.blowup

    def caps():
        return [builder.add_virtual_hash() for _ in range(cap_size)]

    wires_cap = caps()
    zs_pp_cap = caps()
    quotient_cap = caps()

    openings = {
        "constants_sigmas": [
            (builder.add_virtual_target(), builder.add_virtual_target())
            for _ in range(n_cs_cols)
        ],
        "wires": [
            (builder.add_virtual_target(), builder.add_virtual_target())
            for _ in range(cfg.num_wires)
        ],
        "zs_pp": [
            (builder.add_virtual_target(), builder.add_virtual_target())
            for _ in range(n_zpp)
        ],
        "quotient": [
            (builder.add_virtual_target(), builder.add_virtual_target())
            for _ in range(n_quot)
        ],
        "zs_next": [
            (builder.add_virtual_target(), builder.add_virtual_target())
            for _ in range(cfg.num_challenges)
        ],
    }

    # FRI layer geometry (mirrors fri.fold_layers)
    sizes = []
    m = lde_n
    while m > fri.final_poly_len * fri.blowup:
        sizes.append(m)
        m //= 2
    final_len = m // fri.blowup

    fri_caps = []
    for m_l in sizes:
        half = m_l // 2
        ch = min(fri.cap_height, (half).bit_length() - 1)
        fri_caps.append([builder.add_virtual_hash() for _ in range(1 << ch)])
    final_poly = [
        (builder.add_virtual_target(), builder.add_virtual_target())
        for _ in range(final_len)
    ]
    pow_witness = builder.add_virtual_target()

    initial_leaves = []
    initial_paths = []
    fri_leaves = []
    fri_paths = []
    log_lde = lde_n.bit_length() - 1
    for _ in range(fri.num_query_rounds):
        leaves = {
            "constants_sigmas": builder.add_virtual_targets(n_cs_cols),
            "wires": builder.add_virtual_targets(cfg.num_wires),
            "zs_pp": builder.add_virtual_targets(n_zpp),
            "quotient": builder.add_virtual_targets(n_quot),
        }
        paths = {
            name: [builder.add_virtual_hash() for _ in range(log_lde - fri.cap_height)]
            for name in leaves
        }
        initial_leaves.append(leaves)
        initial_paths.append(paths)
        per_layer_leaves = []
        per_layer_paths = []
        for m_l in sizes:
            half = m_l // 2
            ch = min(fri.cap_height, half.bit_length() - 1)
            per_layer_leaves.append(builder.add_virtual_targets(4))
            per_layer_paths.append(
                [builder.add_virtual_hash() for _ in range(half.bit_length() - 1 - ch)]
            )
        fri_leaves.append(per_layer_leaves)
        fri_paths.append(per_layer_paths)

    public_inputs = builder.add_virtual_targets(common.num_public_inputs)

    return ProofTarget(
        wires_cap=wires_cap,
        zs_pp_cap=zs_pp_cap,
        quotient_cap=quotient_cap,
        openings=openings,
        fri_caps=fri_caps,
        final_poly=final_poly,
        pow_witness=pow_witness,
        initial_leaves=initial_leaves,
        initial_paths=initial_paths,
        fri_leaves=fri_leaves,
        fri_paths=fri_paths,
        public_inputs=public_inputs,
    )


def _u64(v) -> int:
    """A proof value as the u64 it stands for.  A value read from an int64
    bit-pattern tensor is negative from 2^63 up; taken mod p as it is, it
    would be the wrong residue."""
    return int(v) & 0xFFFFFFFFFFFFFFFF


def set_proof_target_witness(pw, pt: ProofTarget, proof) -> None:
    """Fill all proof targets from a host Proof object; every value goes
    through ``_u64`` before it enters the witness."""
    from ..utils.hash_out import HashOut

    def set_hash(t, d):
        pw.set_hash_target(t, HashOut(tuple(_u64(x) for x in d)))

    def set_caps(targets, cap):
        for t, d in zip(targets, cap):
            set_hash(t, d)

    def set_ext(t, v):
        pw.set_target(t[0], _u64(v[0]))
        pw.set_target(t[1], _u64(v[1]))

    set_caps(pt.wires_cap, proof.wires_cap)
    set_caps(pt.zs_pp_cap, proof.zs_pp_cap)
    set_caps(pt.quotient_cap, proof.quotient_cap)
    for name in ["constants_sigmas", "wires", "zs_pp", "quotient", "zs_next"]:
        for t, v in zip(pt.openings[name], proof.openings[name]):
            set_ext(t, v)
    for cap_t, cap in zip(pt.fri_caps, proof.fri.caps):
        set_caps(cap_t, cap)
    for t, c in zip(pt.final_poly, proof.fri.final_poly):
        set_ext(t, c)
    pw.set_target(pt.pow_witness, _u64(proof.fri.pow_witness))
    for q in range(len(pt.initial_leaves)):
        per = proof.initial_openings[q]
        for name, leaf_targets in pt.initial_leaves[q].items():
            leaf, path = per[name]
            for t, v in zip(leaf_targets, leaf):
                pw.set_target(t, _u64(v))
            for ht, d in zip(pt.initial_paths[q][name], path):
                set_hash(ht, d)
        for layer, (leaf, path) in enumerate(proof.fri.query_rounds[q]):
            for t, v in zip(pt.fri_leaves[q][layer], leaf):
                pw.set_target(t, _u64(v))
            for ht, d in zip(pt.fri_paths[q][layer], path):
                set_hash(ht, d)
    for t, v in zip(pt.public_inputs, proof.public_inputs):
        pw.set_target(t, _u64(v))


# ---------------------------------------------------------------------------
# the verifier circuit
# ---------------------------------------------------------------------------


def _verify_merkle_path(builder, leaf_targets, idx_bits, path, caps, cap_bits):
    """Hash leaf, fold up the path with swap bits, select the cap entry by
    the remaining bits, and connect."""
    if len(leaf_targets) <= 4:
        padded = list(leaf_targets) + [builder.zero()] * (4 - len(leaf_targets))
        digest = HashOutTarget(tuple(padded))
    else:
        digest = builder.hash_n_to_hash_no_pad(list(leaf_targets))
    for bit, sibling in zip(idx_bits, path):
        digest = builder.two_to_one_swapped(digest, sibling, bit)
    expected = _select_digest(builder, cap_bits, caps)
    builder.connect_hashes(digest, expected)


def verify_proof_in_circuit(
    builder: CircuitBuilder, common, pt: ProofTarget
) -> None:
    """The full in-circuit verifier; mirrors ``engine/verifier.py``."""
    cfg: CircuitConfig = common.config
    fri = cfg.fri
    n = common.n
    lde_n = n * fri.blowup
    log_lde = lde_n.bit_length() - 1
    R = cfg.num_routed_wires
    nch = n_chunks(R)
    alg = ExtTargetAlgebra(builder)

    # ---- transcript ----
    ch = ChallengerTarget(builder)
    ch.observe_hash(builder.constant_hash(common.circuit_digest))
    pi_hash = builder.hash_n_to_hash_no_pad(list(pt.public_inputs))
    ch.observe_hash(pi_hash)
    ch.observe_cap(pt.wires_cap)
    betas = ch.get_n_challenges(cfg.num_challenges)
    gammas = ch.get_n_challenges(cfg.num_challenges)
    ch.observe_cap(pt.zs_pp_cap)
    alphas = ch.get_n_challenges(cfg.num_challenges)
    ch.observe_cap(pt.quotient_cap)
    zeta = ch.get_extension_challenge()
    for name in ["constants_sigmas", "wires", "zs_pp", "quotient", "zs_next"]:
        for o in pt.openings[name]:
            ch.observe_ext(o)
    alpha_fri = ch.get_extension_challenge()

    # ---- vanishing / quotient identity at zeta ----
    ops = pt.openings
    n_sel = common.n_sel
    sel = ops["constants_sigmas"][:n_sel]
    consts = ops["constants_sigmas"][n_sel : n_sel + common.n_const_cols]
    sigmas_z = ops["constants_sigmas"][n_sel + common.n_const_cols :]
    wires_z = ops["wires"]
    zs_z = ops["zs_pp"][: cfg.num_challenges]
    pps_z = [
        ops["zs_pp"][
            cfg.num_challenges + c * (nch - 1) : cfg.num_challenges + (c + 1) * (nch - 1)
        ]
        for c in range(cfg.num_challenges)
    ]
    zs_next = ops["zs_next"]
    quot_z = [
        ops["quotient"][c * fri.blowup : (c + 1) * fri.blowup]
        for c in range(cfg.num_challenges)
    ]

    pi_hash_ext = [alg.from_base_target(t) for t in pi_hash]
    gate_constraint_vals = []
    for gi, gate_id in enumerate(common.gate_ids):
        gate = GATE_TYPES[gate_id]
        if gate.num_constraints == 0:
            continue
        cs = gate.eval_constraints(alg, wires_z, consts, pi_hash_ext)
        gate_constraint_vals.extend(alg.mul(sel[gi], c) for c in cs)

    # zeta^n by repeated squaring (n is a power of two)
    zeta_n = zeta
    for _ in range(n.bit_length() - 1):
        zeta_n = alg.mul(zeta_n, zeta_n)
    z_h_zeta = alg.sub(zeta_n, alg.one())
    l0_den = alg.mul_const(alg.sub(zeta, alg.one()), n)
    l0 = alg.mul(z_h_zeta, alg.inverse(l0_den))

    for c in range(cfg.num_challenges):
        beta, gamma = betas[c], gammas[c]
        terms = [alg.mul(l0, alg.sub(zs_z[c], alg.one()))]
        prev = zs_z[c]
        for j in range(nch):
            lo, hi = j * CHUNK, min((j + 1) * CHUNK, R)
            f = alg.one()
            g = alg.one()
            for i in range(lo, hi):
                v = wires_z[i]
                k_beta = builder.mul_const(common.k_is[i], beta)
                id_term = alg.mul_base(zeta, k_beta)
                f_fac = alg.add(alg.add(v, id_term), alg.from_base_target(gamma))
                f = alg.mul(f, f_fac)
                g_fac = alg.add(
                    alg.add(v, alg.mul_base(sigmas_z[i], beta)),
                    alg.from_base_target(gamma),
                )
                g = alg.mul(g, g_fac)
            nxt = zs_next[c] if j == nch - 1 else pps_z[c][j]
            terms.append(alg.sub(alg.mul(nxt, g), alg.mul(prev, f)))
            if j < nch - 1:
                prev = pps_z[c][j]
        terms.extend(gate_constraint_vals)

        vanishing = alg.zero()
        apow = alg.one()
        for t in terms:
            vanishing = alg.add(vanishing, alg.mul(apow, t))
            apow = alg.mul_base(apow, alphas[c])

        q = alg.zero()
        zpow = alg.one()
        for i in range(fri.blowup):
            q = alg.add(q, alg.mul(zpow, quot_z[c][i]))
            zpow = alg.mul(zpow, zeta_n)
        rhs = alg.mul(z_h_zeta, q)
        builder.connect(vanishing[0], rhs[0])
        builder.connect(vanishing[1], rhs[1])

    # ---- FRI ----
    g_n = glh.primitive_root_of_unity(n.bit_length() - 1)
    gzeta = alg.mul_const(zeta, g_n)

    flat_opens = (
        ops["constants_sigmas"] + ops["wires"] + ops["zs_pp"] + ops["quotient"]
    )
    m1 = len(flat_opens)
    alpha_pows = [alg.one()]
    for _ in range(m1 + cfg.num_challenges - 1):
        alpha_pows.append(alg.mul(alpha_pows[-1], alpha_fri))
    comb1_at_zeta = alg.zero()
    for i, y in enumerate(flat_opens):
        comb1_at_zeta = alg.add(comb1_at_zeta, alg.mul(alpha_pows[i], y))
    comb2_at_gzeta = alg.zero()
    for j, y in enumerate(ops["zs_next"]):
        comb2_at_gzeta = alg.add(comb2_at_gzeta, alg.mul(alpha_pows[m1 + j], y))

    # replay fold transcript
    fri_betas = []
    for cap in pt.fri_caps:
        ch.observe_cap(cap)
        fri_betas.append(ch.get_extension_challenge())
    for coeff in pt.final_poly:
        ch.observe_ext(coeff)

    # grinding
    if fri.proof_of_work_bits > 0:
        pow_challenge = ch.get_challenge()
        pow_digest = builder.hash_n_to_hash_no_pad([pow_challenge, pt.pow_witness])
        d_bits = builder.split_le_canonical(list(pow_digest)[0])
        for b in d_bits[64 - fri.proof_of_work_bits :]:
            builder.assert_zero(b.target)
        ch.observe_element(pt.pow_witness)
    else:
        ch.observe_element(builder.zero())

    # layer geometry
    sizes = []
    m = lde_n
    shift = glh.MULTIPLICATIVE_GROUP_GENERATOR % P
    shifts = []
    while m > fri.final_poly_len * fri.blowup:
        sizes.append(m)
        shifts.append(shift)
        shift = shift * shift % P
        m //= 2
    final_m = m
    final_shift = shift

    inv2 = pow(2, P - 2, P)
    caps_by_name = {
        "constants_sigmas": [builder.constant_hash(d) for d in common.constants_sigmas_cap],
        "wires": pt.wires_cap,
        "zs_pp": pt.zs_pp_cap,
        "quotient": pt.quotient_cap,
    }

    for qr in range(fri.num_query_rounds):
        idx_t = ch.get_challenge()
        all_bits = builder.split_le_canonical(idx_t)
        idx_bits = all_bits[:log_lde]  # idx = challenge mod lde_n

        # initial tree openings at idx
        cap_bits = idx_bits[log_lde - fri.cap_height :]
        path_bits = idx_bits[: log_lde - fri.cap_height]
        for name in ["constants_sigmas", "wires", "zs_pp", "quotient"]:
            _verify_merkle_path(
                builder,
                pt.initial_leaves[qr][name],
                path_bits,
                pt.initial_paths[qr][name],
                caps_by_name[name],
                cap_bits,
            )

        # combined value at x_idx
        values = []
        for name in ["constants_sigmas", "wires", "zs_pp", "quotient"]:
            values.extend(pt.initial_leaves[qr][name])
        comb1 = alg.zero()
        for i, y in enumerate(values):
            comb1 = alg.add(comb1, alg.mul_base(alpha_pows[i], y))
        comb2 = alg.zero()
        for j in range(cfg.num_challenges):
            comb2 = alg.add(
                comb2, alg.mul_base(alpha_pows[m1 + j], pt.initial_leaves[qr]["zs_pp"][j])
            )
        x = builder.mul_const(
            glh.MULTIPLICATIVE_GROUP_GENERATOR,
            _pow_from_bits(builder, idx_bits, glh.primitive_root_of_unity(log_lde)),
        )
        x_ext = alg.from_base_target(x)
        t1 = alg.mul(alg.sub(comb1, comb1_at_zeta), alg.inverse(alg.sub(x_ext, zeta)))
        t2 = alg.mul(alg.sub(comb2, comb2_at_gzeta), alg.inverse(alg.sub(x_ext, gzeta)))
        value = alg.add(t1, t2)

        # fold through the layers
        for layer, m_l in enumerate(sizes):
            log_half = m_l.bit_length() - 2  # log2(m_l / 2)
            qi_bits = idx_bits[:log_half]
            b_top = idx_bits[log_half]  # 1 -> we are the negative point
            leaf = pt.fri_leaves[qr][layer]
            e_pos = (leaf[0], leaf[1])
            e_neg = (leaf[2], leaf[3])
            ch_l = min(fri.cap_height, log_half)
            _verify_merkle_path(
                builder,
                list(leaf),
                qi_bits[: log_half - ch_l],
                pt.fri_paths[qr][layer],
                pt.fri_caps[layer],
                qi_bits[log_half - ch_l :] if ch_l > 0 else [],
            )
            opened = alg.select(b_top, e_neg, e_pos)
            builder.connect(opened[0], value[0])
            builder.connect(opened[1], value[1])
            # fold
            w_l = glh.primitive_root_of_unity(m_l.bit_length() - 1)
            x_l = builder.mul_const(
                shifts[layer], _pow_from_bits(builder, qi_bits, w_l)
            )
            half_sum = alg.mul_const(alg.add(e_pos, e_neg), inv2)
            diff = alg.sub(e_pos, e_neg)
            inv_2x = alg.inverse(alg.from_base_target(builder.mul_const(2, x_l)))
            slope = alg.mul(diff, inv_2x)
            value = alg.add(half_sum, alg.mul(slope, fri_betas[layer]))

        # final polynomial evaluation at x_final = shift_final * w^qfinal
        log_final = final_m.bit_length() - 1
        q_bits = idx_bits[:log_final]
        w_f = glh.primitive_root_of_unity(log_final)
        x_f = builder.mul_const(final_shift, _pow_from_bits(builder, q_bits, w_f))
        acc = alg.zero()
        for coeff in reversed(pt.final_poly):
            acc = alg.add(alg.mul_base(acc, x_f), coeff)
        builder.connect(acc[0], value[0])
        builder.connect(acc[1], value[1])
