// Native witness-generation engine.
//
// Executes the engine's declarative generator records (see
// engine/generators.py) over the circuit's union-find target classes to a
// fixpoint — the host-side hot loop of proving (reference counterpart: the
// plonky2 generator queue its SimpleGenerator trait objects run in,
// consumed via CircuitData::prove).  The Python fill remains the exact
// oracle and the fallback; kinds the engine does not know (model-layer
// registrations, e.g. ECDSA bignum computes) stay in Python and the two
// interleave passes over the same value arrays.
//
// All arithmetic is Goldilocks (p = 2^64 - 2^32 + 1) via __uint128_t.
// Round constants / MDS / fast-partial tables are injected from the single
// Python source of truth at load time (witness_init) — nothing is
// transcribed here.

#include <cstdint>
#include <cstring>

typedef unsigned __int128 u128;
typedef uint64_t u64;
typedef int64_t i64;

static const u64 P = 0xFFFFFFFF00000001ULL;

static u64 RC[360];      // 30 rounds x 12 lanes
static u64 MDS[144];     // dense 12x12 (circulant + diag)
// fast-partial affine tables: basis [1, Y0..Y11, x0..x21] (width 35)
static u64 PARTIAL_A[22 * 35];
static u64 PARTIAL_B[12 * 35];

static inline u64 addmod(u64 a, u64 b) {
    u128 s = (u128)a + b;
    return (u64)(s >= P ? s - P : s);
}

static inline u64 submod(u64 a, u64 b) { return a >= b ? a - b : a + P - b; }

static inline u64 mulmod(u64 a, u64 b) { return (u64)(((u128)a * b) % P); }

static inline u64 powmod(u64 a, u64 e) {
    u64 r = 1;
    while (e) {
        if (e & 1) r = mulmod(r, a);
        a = mulmod(a, a);
        e >>= 1;
    }
    return r;
}

static inline u64 sbox7(u64 x) {
    u64 x2 = mulmod(x, x);
    u64 x3 = mulmod(x2, x);
    return mulmod(mulmod(x3, x3), x);
}

extern "C" void witness_init(const u64* rc, const u64* mds,
                             const u64* partial_a, const u64* partial_b) {
    memcpy(RC, rc, sizeof(RC));
    memcpy(MDS, mds, sizeof(MDS));
    memcpy(PARTIAL_A, partial_a, sizeof(PARTIAL_A));
    memcpy(PARTIAL_B, partial_b, sizeof(PARTIAL_B));
}

// ---------------------------------------------------------------------------
// engine state: union-find + per-root values
// ---------------------------------------------------------------------------

struct Fill {
    i64* parent;   // [n] (path-compressed in place)
    u64* values;   // [n] value of ROOT target
    uint8_t* has;  // [n]
    i64* wire_rows;  // appended overrides
    i64* wire_cols;
    u64* wire_vals;
    i64 n_wires;
    i64 conflict_target;  // -1 or first conflicting target

    i64 find(i64 t) {
        i64 root = t;
        while (parent[root] != root) root = parent[root];
        while (parent[t] != root) {
            i64 nxt = parent[t];
            parent[t] = root;
            t = nxt;
        }
        return root;
    }

    bool get(i64 t, u64* out) {
        i64 r = find(t);
        if (!has[r]) return false;
        *out = values[r];
        return true;
    }

    // returns false on conflict
    bool set(i64 t, u64 v) {
        i64 r = find(t);
        v %= P;
        if (has[r]) {
            if (values[r] != v) {
                conflict_target = t;
                return false;
            }
            return true;
        }
        has[r] = 1;
        values[r] = v;
        return true;
    }

    void set_wire(i64 row, i64 col, u64 v) {
        wire_rows[n_wires] = row;
        wire_cols[n_wires] = col;
        wire_vals[n_wires] = v % P;
        n_wires++;
    }
};

// ---------------------------------------------------------------------------
// generator kinds (ids match native/loader.py NATIVE_KINDS)
// ---------------------------------------------------------------------------

static const i64 K_ARITH = 0, K_INV_OR_ZERO = 1, K_SPLIT_LE = 2,
                 K_POSEIDON = 3, K_U32_MUL_ADD = 4, K_EXT_INVERSE = 5;

// PoseidonGate wire layout (engine/gates.py)
static const i64 W_OUT = 12, W_DELTA = 25, W_FULL1 = 29, W_PARTIAL = 65,
                 W_S26 = 87, W_FULL2 = 99;
// U32MulAddGate layout
static const i64 U32_CHUNK_BASE = 15, U32_INV_BASE = 111;

static void mds_apply(const u64* in, u64* out) {
    for (int r = 0; r < 12; r++) {
        u128 acc = 0;  // coefficients < 50: sum of 12 products < 2^74
        for (int c = 0; c < 12; c++) acc += (u128)MDS[r * 12 + c] * in[c];
        out[r] = (u64)(acc % P);
    }
}

// one record; returns 1 = progressed, 0 = inputs missing, -1 = conflict
static int run_record(Fill& f, const u64* p, i64 kind) {
    switch (kind) {
        case K_ARITH: {  // a, b, c, out, c0, c1
            u64 va, vb, vc;
            if (!f.get((i64)p[0], &va) || !f.get((i64)p[1], &vb) ||
                !f.get((i64)p[2], &vc))
                return 0;
            u64 v = addmod(mulmod(mulmod(p[4] % P, va), vb), mulmod(p[5] % P, vc));
            return f.set((i64)p[3], v) ? 1 : -1;
        }
        case K_INV_OR_ZERO: {  // src, inv
            u64 v;
            if (!f.get((i64)p[0], &v)) return 0;
            return f.set((i64)p[1], v ? powmod(v, P - 2) : 0) ? 1 : -1;
        }
        case K_SPLIT_LE: {  // t, n_bits, bit0..  (n_bits from nparams)
            u64 v;
            if (!f.get((i64)p[0], &v)) return 0;
            i64 n_bits = (i64)p[1];
            for (i64 i = 0; i < n_bits; i++)
                if (!f.set((i64)p[2 + i], (v >> i) & 1)) return -1;
            return 1;
        }
        case K_POSEIDON: {  // row, in0..in11, swap, out0..out11
            u64 in[12], swap;
            for (int i = 0; i < 12; i++)
                if (!f.get((i64)p[1 + i], &in[i])) return 0;
            if (!f.get((i64)p[13], &swap)) return 0;
            i64 row = (i64)p[0];
            u64 delta[4], sin[12], state[12], tmp[12];
            for (int i = 0; i < 4; i++) {
                delta[i] = mulmod(swap, submod(in[4 + i], in[i]));
                f.set_wire(row, W_DELTA + i, delta[i]);
            }
            for (int i = 0; i < 4; i++) sin[i] = addmod(in[i], delta[i]);
            for (int i = 0; i < 4; i++) sin[4 + i] = submod(in[4 + i], delta[i]);
            for (int i = 8; i < 12; i++) sin[i] = in[i];
            memcpy(state, sin, sizeof(state));
            for (int r = 0; r < 3; r++) {
                for (int i = 0; i < 12; i++)
                    tmp[i] = sbox7(addmod(state[i], RC[12 * r + i]));
                mds_apply(tmp, state);
                for (int i = 0; i < 12; i++)
                    f.set_wire(row, W_FULL1 + 12 * r + i, state[i]);
            }
            u64 basis[35];
            basis[0] = 1;
            for (int i = 0; i < 12; i++)
                basis[1 + i] = sbox7(addmod(state[i], RC[12 * 3 + i]));
            for (int i = 0; i < 22; i++) basis[13 + i] = 0;
            for (int i = 0; i < 22; i++) {
                u64 acc = 0;
                const u64* rowa = &PARTIAL_A[i * 35];
                for (int j = 0; j < 35; j++)
                    if (rowa[j]) acc = addmod(acc, mulmod(rowa[j], basis[j]));
                f.set_wire(row, W_PARTIAL + i, acc);
                basis[13 + i] = sbox7(acc);
            }
            for (int lane = 0; lane < 12; lane++) {
                u64 acc = 0;
                const u64* rowb = &PARTIAL_B[lane * 35];
                for (int j = 0; j < 35; j++)
                    if (rowb[j]) acc = addmod(acc, mulmod(rowb[j], basis[j]));
                f.set_wire(row, W_S26 + lane, acc);
                state[lane] = acc;
            }
            for (int k = 0; k < 3; k++) {
                int rnd = 26 + k;
                for (int i = 0; i < 12; i++)
                    tmp[i] = sbox7(addmod(state[i], RC[12 * rnd + i]));
                mds_apply(tmp, state);
                for (int i = 0; i < 12; i++)
                    f.set_wire(row, W_FULL2 + 12 * k + i, state[i]);
            }
            for (int i = 0; i < 12; i++)
                tmp[i] = sbox7(addmod(state[i], RC[12 * 29 + i]));
            mds_apply(tmp, state);
            for (int i = 0; i < 12; i++)
                if (!f.set((i64)p[14 + i], state[i])) return -1;
            return 1;
        }
        case K_U32_MUL_ADD: {  // a, b, c, row, op, out_lo, out_hi
            u64 va, vb, vc;
            if (!f.get((i64)p[0], &va) || !f.get((i64)p[1], &vb) ||
                !f.get((i64)p[2], &vc))
                return 0;
            i64 row = (i64)p[3], op = (i64)p[4];
            u128 v = (u128)va * vb + vc;
            u64 lo = (u64)(v & 0xFFFFFFFFULL);
            u64 hi = (u64)(v >> 32);
            if (!f.set((i64)p[5], lo)) return -1;
            if (!f.set((i64)p[6], hi)) return -1;
            for (int k = 0; k < 16; k++)
                f.set_wire(row, U32_CHUNK_BASE + 32 * op + k, (lo >> (2 * k)) & 3);
            for (int k = 0; k < 16; k++)
                f.set_wire(row, U32_CHUNK_BASE + 32 * op + 16 + k,
                           (hi >> (2 * k)) & 3);
            u64 diff = submod(hi, 0xFFFFFFFFULL);
            f.set_wire(row, U32_INV_BASE + op, diff ? powmod(diff, P - 2) : 0);
            return 1;
        }
        case K_EXT_INVERSE: {  // x0, x1, inv0, inv1, w_ext
            u64 v0, v1;
            if (!f.get((i64)p[0], &v0) || !f.get((i64)p[1], &v1)) return 0;
            u64 norm = submod(mulmod(v0, v0), mulmod(p[4] % P, mulmod(v1, v1)));
            u64 ninv = powmod(norm, P - 2);
            if (!f.set((i64)p[2], mulmod(v0, ninv))) return -1;
            if (!f.set((i64)p[3], mulmod(P - (v1 % P), ninv))) return -1;
            return 1;
        }
    }
    return 0;  // unknown kind: leave for Python
}

// Run the record stream to a fixpoint.
// stream layout per record: [kind, nparams, params...] as u64.
// Returns: number of still-pending records (>= 0), or -1 on conflict.
extern "C" i64 witness_run(
    i64 n_targets, i64* parent, u64* values, uint8_t* has,
    const u64* stream, i64 n_records, const i64* rec_offsets,
    uint8_t* done,  // [n_records] in/out
    i64* wire_rows, i64* wire_cols, u64* wire_vals, i64* n_wires_io,
    i64* conflict_target_out) {
    Fill f;
    f.parent = parent;
    f.values = values;
    f.has = has;
    f.wire_rows = wire_rows;
    f.wire_cols = wire_cols;
    f.wire_vals = wire_vals;
    f.n_wires = *n_wires_io;
    f.conflict_target = -1;

    (void)n_targets;
    i64 pending = 0;
    for (i64 r = 0; r < n_records; r++)
        if (!done[r]) pending++;

    while (pending > 0) {
        i64 progressed = 0;
        for (i64 r = 0; r < n_records; r++) {
            if (done[r]) continue;
            const u64* rec = stream + rec_offsets[r];
            int res = run_record(f, rec + 2, (i64)rec[0]);
            if (res < 0) {
                *conflict_target_out = f.conflict_target;
                *n_wires_io = f.n_wires;
                return -1;
            }
            if (res > 0) {
                done[r] = 1;
                progressed++;
            }
        }
        if (!progressed) break;  // stuck: leave the rest to Python kinds
        pending -= progressed;
    }
    *n_wires_io = f.n_wires;
    *conflict_target_out = -1;
    return pending;
}
