// Host-side Goldilocks Poseidon accelerator.
//
// Witness generation is pointer-chasing host work (SMT inserts walk the
// tree with ~2*depth sequential permutations, reference call stack
// SURVEY.md §3.3); the Python scalar path costs ~100µs/permutation.  This
// translation unit provides the same permutation over __uint128_t at
// ~1µs, exposed through a C ABI consumed via ctypes.
//
// The round constants / MDS matrix are passed in at init so the single
// source of truth stays in ops/poseidon_constants.py.

#include <cstdint>
#include <cstring>

namespace {

constexpr uint64_t P = 0xFFFFFFFF00000001ULL;
constexpr int WIDTH = 12;
constexpr int N_ROUNDS = 30;
constexpr int HALF_FULL = 4;
constexpr int N_PARTIAL = 22;

uint64_t g_rc[N_ROUNDS * WIDTH];
uint64_t g_mds[WIDTH * WIDTH];

inline uint64_t add_mod(uint64_t a, uint64_t b) {
    uint64_t s = a + b;
    if (s < a) s += 0xFFFFFFFFULL;  // += 2^64 mod p
    if (s >= P) s -= P;
    return s;
}

inline uint64_t reduce128(unsigned __int128 x) {
    uint64_t lo = (uint64_t)x;
    uint64_t hi = (uint64_t)(x >> 64);
    uint64_t hi_hi = hi >> 32;
    uint64_t hi_lo = hi & 0xFFFFFFFFULL;
    uint64_t t0 = lo - hi_hi;
    if (lo < hi_hi) t0 -= 0xFFFFFFFFULL;
    uint64_t t1 = hi_lo * 0xFFFFFFFFULL;
    uint64_t t2 = t0 + t1;
    if (t2 < t0) t2 += 0xFFFFFFFFULL;
    if (t2 >= P) t2 -= P;
    return t2;
}

inline uint64_t mul_mod(uint64_t a, uint64_t b) {
    return reduce128((unsigned __int128)a * b);
}

inline uint64_t sbox(uint64_t x) {
    uint64_t x2 = mul_mod(x, x);
    uint64_t x3 = mul_mod(x2, x);
    uint64_t x6 = mul_mod(x3, x3);
    return mul_mod(x6, x);
}

inline void mds_layer(const uint64_t* in, uint64_t* out) {
    for (int r = 0; r < WIDTH; r++) {
        unsigned __int128 acc = 0;
        const uint64_t* row = &g_mds[r * WIDTH];
        for (int c = 0; c < WIDTH; c++) {
            acc += (unsigned __int128)row[c] * in[c];
        }
        out[r] = reduce128(acc);
    }
}

void permute_one(uint64_t* state) {
    uint64_t tmp[WIDTH];
    for (int rnd = 0; rnd < N_ROUNDS; rnd++) {
        const uint64_t* rc = &g_rc[rnd * WIDTH];
        for (int i = 0; i < WIDTH; i++) state[i] = add_mod(state[i], rc[i]);
        if (rnd < HALF_FULL || rnd >= HALF_FULL + N_PARTIAL) {
            for (int i = 0; i < WIDTH; i++) state[i] = sbox(state[i]);
        } else {
            state[0] = sbox(state[0]);
        }
        mds_layer(state, tmp);
        std::memcpy(state, tmp, sizeof(tmp));
    }
}

}  // namespace

extern "C" {

// rc: 360 u64; mds: 144 u64 (row-major dense matrix)
void poseidon_init(const uint64_t* rc, const uint64_t* mds) {
    std::memcpy(g_rc, rc, sizeof(g_rc));
    std::memcpy(g_mds, mds, sizeof(g_mds));
}

// states: [n, 12] u64, permuted in place
void poseidon_permute_batch(uint64_t* states, int64_t n) {
    for (int64_t i = 0; i < n; i++) permute_one(states + i * WIDTH);
}

// inputs: [n_inputs] u64 sponge input, rate-8 overwrite absorb; out: 4 u64
void poseidon_hash_no_pad(const uint64_t* inputs, int64_t n_inputs, uint64_t* out) {
    uint64_t state[WIDTH] = {0};
    for (int64_t start = 0; start < n_inputs; start += 8) {
        int64_t m = n_inputs - start < 8 ? n_inputs - start : 8;
        for (int64_t i = 0; i < m; i++) state[i] = inputs[start + i];
        permute_one(state);
    }
    std::memcpy(out, state, 4 * sizeof(uint64_t));
}

}  // extern "C"
