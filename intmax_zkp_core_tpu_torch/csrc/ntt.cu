// NTT and inverse NTT over Goldilocks for Hopper (sm_90a), natural order in
// and out.
//
// Replaces the JAX package's Pallas kernel
//   ops/ntt_pallas.py::ntt_pallas (_local_stage) -> ntt_local
//
// One kernel template, the local transform of length N = 2^M (M <= 11):
// each block takes G neighbouring sequences, addressed by (sequence,
// element) strides, and writes their transforms in natural order through
// output strides, optionally times a per-point twiddle and a scale.  The
// wrapper (ops/ntt_cuda.py::ntt_cuda) makes a transform of it:
//   n <= 2^11: one launch, each row a sequence, the inverse's 1/n as the scale;
//   n  > 2^11: the four-step of the TPU kernel, n = n1 * n2 viewed as [n1, n2]:
//     launch 1, the n2 columns as sequences of length n1, each output times
//       w^(i2 * k1) (the inverse's 1/n folded into that table);
//     launch 2, the n1 rows as sequences of length n2, written transposed, so
//       X[k1 + n1 * k2] lands at k2 * n1 + k1: natural order, no extra pass;
//   n  > 2^22 (the JAX package falls back to XLA there; no TPU kernel): an
//     outer four-step with n1 = 2^11, launch 1 as above with 1/n1 in the
//     table, the rows' length-n2 transforms by the wrapper itself (four-step,
//     n2 > 2^11), then ntt_transpose writes [n1, n2] as [n2, n1].
// The grid's second axis carries the batch rows: the wrapper splits more
// than 65,535 of them over launches.
//
// The transform is the plain version's radix-2 decimation in time
// (ops/ntt.py::_ntt_impl: bit-reversed input; stage s joins blocks of
// 2^(s-1) with twiddles w_{2^s}^j), its stages taken three at a time in
// registers.  A thread holds R = 8 elements (R = N below 8):
//   pass 1 reads them straight from device memory: the elements u + rev(t) N/8
//     of its sequence, which are the positions 8 rev(u) + t of the
//     bit-reversed order, so the reversal costs no pass; it runs the first
//     R1 = M - 3 (PASSES - 1) stages (1 to 3) on them;
//   every later pass takes the 8 positions b + t 2^s0 of one group (b has
//     bits s0 .. s0+2 clear), multiplies element t by W^rev(t),
//     W = w_{2^(s0+3)}^(b mod 2^s0), read from the table of powers of w_N,
//     and runs its three stages, whose twiddles are then the 8th roots of
//     unity w8, w4 = w8^2 and w8^3 alone (the twiddles of three stages factor
//     into these and the one product per element);
//   between passes the elements go through shared memory: ceil(M / 3) - 1
//     exchanges and as many barriers for M stages;
//   the last pass writes its elements u + k N/8 straight to device memory.
// Values are loose (any u64 standing for its residue; goldilocks.cuh) from
// the first product to the write, where each is made canonical once.  The
// loose add and subtract take a canonical second operand, so each butterfly
// makes its product canonical first: three instructions, and then no
// correction can wrap twice.
//
// Memory: pass 1 and the last pass read and write device memory with
// neighbouring threads on neighbouring addresses: along a row where the
// sequence is contiguous, across the G >= 8 neighbouring sequences where it
// is strided (the columns of launch 1, the transposed write of launch 2), so
// each warp moves 64-byte segments at least.  Shared memory holds the
// block's G N elements (at most 2^12: 32 KB, six blocks to an SM; 16
// sequences of 2^9 in 64 KB, for 128-byte segments, measured slower:
// experiments/ntt_gate_variants.py), element p of sequence g at slot
// p G + g, XOR-swizzled (swz below) so that the scatter of pass 1 and the
// gather of the last pass, which touch slots a multiple of 16 G apart,
// spread over the banks.
//
// What bounds it on this card: each launch reads and writes B * n u64 once
// and spends about one product per element per pass: bytes, not operations,
// are the limit (see chip_smoke.py::ntt_bound).
//
// The values are bit-identical to the plain version's because every
// operation is exact mod p and the pass structure and the four-step are exact
// identities (tests/test_torch_ntt.py replays this schedule in Python ints).
#include <cuda_runtime.h>

#include "goldilocks.cuh"

#define THREADS 256
#define MIN_BLOCKS 4
#define MAX_LOG_LEN 11
#define BLOCK_LOG_ELEMS 12  // a block holds at most 2^12 u64 (32 KB of shared memory)

// Slot of element a of a block's shared memory: the low four bits (one
// 128-byte row of banks) XORed with bits 4-7, 8-11 and 12-15.  A bijection on
// every aligned run of 16 slots.
__device__ __forceinline__ int swz(int a) { return a ^ (((a >> 4) ^ (a >> 8) ^ (a >> 12)) & 15); }

template <int BITS>
__device__ __forceinline__ int rev_bits(int x) {
    if constexpr (BITS == 0) {
        return 0;
    } else {
        return (int)(__brev((unsigned int)x) >> (32 - BITS));
    }
}

// (even, odd) <- (even + t, even - t) for t = odd * twiddle: even loose, t
// loose and made canonical here.
__device__ __forceinline__ void butterfly(u64& even, u64& odd, u64 t) {
    t = gl_canon(t);
    const u64 e = even;
    even = gl_add_loose(e, t);
    odd = gl_sub_loose(e, t);
}

// Stages 1 .. S (S <= 3) of the decimation in time on the R elements of y in
// bit-reversed storage: stage q pairs t and t + 2^q (bit q of t clear) with
// the twiddle w_{2^(q+1)}^(t mod 2^q), i.e. 1; w4; w8, w8^2 = w4, w8^3.
template <int R, int S>
__device__ __forceinline__ void dit(u64 (&y)[R], u64 w4, u64 w8, u64 w8_3) {
#pragma unroll
    for (int q = 0; q < S; ++q) {
        const int h = 1 << q;
#pragma unroll
        for (int t = 0; t < R; ++t) {
            if (t & h) continue;
            const int j = t & (h - 1);
            u64 prod;
            if (j == 0) {
                prod = y[t + h];
            } else if (q == 1 || j == 2) {
                prod = gl_mul_loose(y[t + h], w4);
            } else if (j == 1) {
                prod = gl_mul_loose(y[t + h], w8);
            } else {
                prod = gl_mul_loose(y[t + h], w8_3);
            }
            butterfly(y[t], y[t + h], prod);
        }
    }
}

// y[t] <- y[t] * W^rev(t), W = w_N^(b_lo << shift), from tw[i] = w_N^i.
__device__ __forceinline__ void pretwiddle(u64 (&y)[8], const u64* __restrict__ tw, int b_lo,
                                           int shift) {
#pragma unroll
    for (int t = 1; t < 8; ++t) y[t] = gl_mul_loose(y[t], __ldg(tw + ((b_lo * rev_bits<3>(t)) << shift)));
}

// Element k of unit u is output u + k * 2^LOG_UNITS of its sequence, whose
// first element is at d: times its four-step twiddle and the scale where
// given, canonical, to device memory.
template <int R, int LOG_UNITS, bool OUT_ROWS>
__device__ __forceinline__ void write_out(u64 (&y)[R], u64* __restrict__ d, int u, int q,
                                          int out_stride, const u64* __restrict__ post_tw,
                                          int post_stride, u64 scale, int has_scale) {
    if (post_tw != nullptr) {
#pragma unroll
        for (int k = 0; k < R; ++k)
            y[k] = gl_mul_loose(
                y[k], __ldg(post_tw + (long long)(u + (k << LOG_UNITS)) * post_stride + q));
    }
    if (has_scale) {
#pragma unroll
        for (int k = 0; k < R; ++k) y[k] = gl_mul_loose(y[k], scale);
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
        const int idx = u + (k << LOG_UNITS);
        d[OUT_ROWS ? (long long)idx : (long long)idx * out_stride] = gl_canon(y[k]);
    }
}

// Sequence q (< n_seq) of batch row y, element i at
//   in[y * batch_stride + q * in_stride + i]   (IN_ROWS: contiguous sequences)
//   in[y * batch_stride + q + i * in_stride]   (else: neighbouring columns);
// its transform's element k to out, addressed the same way by OUT_ROWS and
// out_stride, times post_tw[k * post_stride + q] if post_tw is given and
// times scale if has_scale.  tw [N]: w_N^i.  w4, w8, w8_3: w_4, w_8, w_8^3
// of the direction.  Grid: (n_seq / G rounded up, batch rows), G =
// 2^log_group.  Dynamic shared memory: N * G u64 (none for N <= 8).
template <int M, bool IN_ROWS, bool OUT_ROWS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
ntt_local_kernel(const u64* __restrict__ in, u64* __restrict__ out, int log_group, int n_seq,
                 long long batch_stride, int in_stride, int out_stride, const u64* __restrict__ tw,
                 const u64* __restrict__ post_tw, int post_stride, u64 scale, int has_scale,
                 u64 w4, u64 w8, u64 w8_3) {
    constexpr int RHO = M < 3 ? M : 3;                  // a thread holds 2^RHO elements
    constexpr int R = 1 << RHO;
    constexpr int PASSES = M <= 3 ? 1 : (M + 2) / 3;
    constexpr int R1 = M - 3 * (PASSES - 1);             // stages of pass 1
    constexpr int LOG_UNITS = M - RHO;                   // threads' units per sequence
    extern __shared__ u64 sm[];
    const int group = 1 << log_group;
    const int n_units = 1 << (LOG_UNITS + log_group);
    const int seq0 = blockIdx.x << log_group;
    const u64* src = in + blockIdx.y * batch_stride;
    u64* dst = out + blockIdx.y * batch_stride;

    // pass 1: device memory -> registers -> the first R1 stages.  Where
    // sequences are contiguous the unit index runs fastest across the
    // threads, else the sequence index.
    for (int v = threadIdx.x; v < n_units; v += THREADS) {
        const int u = IN_ROWS ? v & ((1 << LOG_UNITS) - 1) : v >> log_group;
        const int g = IN_ROWS ? v >> LOG_UNITS : v & (group - 1);
        const int q = seq0 + g;
        if (q >= n_seq) continue;
        const u64* s = src + (IN_ROWS ? (long long)q * in_stride : q);
        u64 y[R];
#pragma unroll
        for (int t = 0; t < R; ++t) {
            const int i = u + (rev_bits<RHO>(t) << LOG_UNITS);
            y[t] = s[IN_ROWS ? (long long)i : (long long)i * in_stride];
        }
        dit<R, R1>(y, w4, w8, w8_3);
        if constexpr (PASSES == 1) {
            write_out<R, LOG_UNITS, OUT_ROWS>(y, dst + (OUT_ROWS ? (long long)q * out_stride : q),
                                              u, q, out_stride, post_tw, post_stride, scale,
                                              has_scale);
        } else {
            const int base = ((rev_bits<LOG_UNITS>(u) << RHO) << log_group) + g;
#pragma unroll
            for (int t = 0; t < R; ++t) sm[swz(base + (t << log_group))] = y[t];
        }
    }
    if constexpr (PASSES > 1) {
        // middle passes: shared memory -> twiddle, three stages -> shared memory
#pragma unroll
        for (int pass = 1; pass + 1 < PASSES; ++pass) {
            __syncthreads();
            const int s0 = R1 + 3 * (pass - 1);
            for (int v = threadIdx.x; v < n_units; v += THREADS) {
                const int g = v & (group - 1), cc = v >> log_group;
                if (seq0 + g >= n_seq) continue;
                const int b_lo = cc & ((1 << s0) - 1);
                const int base = ((b_lo + ((cc >> s0) << (s0 + 3))) << log_group) + g;
                u64 y[8];
                int slot[8];
#pragma unroll
                for (int t = 0; t < 8; ++t) {
                    slot[t] = swz(base + ((t << s0) << log_group));
                    y[t] = sm[slot[t]];
                }
                pretwiddle(y, tw, b_lo, M - s0 - 3);
                dit<8, 3>(y, w4, w8, w8_3);
#pragma unroll
                for (int t = 0; t < 8; ++t) sm[slot[t]] = y[t];
            }
        }
        __syncthreads();
        // last pass: shared memory -> twiddle, three stages -> device memory
        for (int v = threadIdx.x; v < n_units; v += THREADS) {
            const int u = OUT_ROWS ? v & ((1 << LOG_UNITS) - 1) : v >> log_group;
            const int g = OUT_ROWS ? v >> LOG_UNITS : v & (group - 1);
            const int q = seq0 + g;
            if (q >= n_seq) continue;
            const int base = (u << log_group) + g;
            u64 y[8];
#pragma unroll
            for (int t = 0; t < 8; ++t) y[t] = sm[swz(base + ((t << LOG_UNITS) << log_group))];
            pretwiddle(y, tw, u, 0);
            dit<8, 3>(y, w4, w8, w8_3);
            write_out<8, LOG_UNITS, OUT_ROWS>(y, dst + (OUT_ROWS ? (long long)q * out_stride : q),
                                              u, q, out_stride, post_tw, post_stride, scale,
                                              has_scale);
        }
    }
}

template <int M, bool IN_ROWS, bool OUT_ROWS>
static int launch_local(const void* in, void* out, int log_group, int n_seq, int batch,
                        long long batch_stride, int in_stride, int out_stride, const void* tw,
                        const void* post_tw, int post_stride, u64 scale, int has_scale, u64 w4,
                        u64 w8, u64 w8_3, void* stream) {
    const size_t shared_bytes = M <= 3 ? 0 : sizeof(u64) << (M + log_group);
    auto kernel = ntt_local_kernel<M, IN_ROWS, OUT_ROWS>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)shared_bytes);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((unsigned int)((n_seq + (1 << log_group) - 1) >> log_group), (unsigned int)batch);
    kernel<<<grid, THREADS, shared_bytes, (cudaStream_t)stream>>>(
        (const u64*)in, (u64*)out, log_group, n_seq, batch_stride, in_stride, out_stride,
        (const u64*)tw, (const u64*)post_tw, post_stride, scale, has_scale, w4, w8, w8_3);
    return (int)cudaGetLastError();
}

// out[b][c][r] = in[b][r][c] for in [batch, rows, cols]: 32 x 32 tiles
// through shared memory (a padding column: the column reads of 8-byte
// elements take every bank of a half warp once).  Grid (cols / 32, rows / 32,
// batch), 32 x 8 threads, each moving 4 elements each way.  A copy: bytes
// bound it.
#define TILE 32
#define TILE_ROWS 8
__global__ void __launch_bounds__(TILE * TILE_ROWS)
transpose_kernel(const u64* __restrict__ in, u64* __restrict__ out, int rows, int cols) {
    __shared__ u64 tile[TILE][TILE + 1];
    const long long base = (long long)blockIdx.z * rows * cols;
    const int c0 = blockIdx.x * TILE, r0 = blockIdx.y * TILE;
    for (int k = threadIdx.y; k < TILE; k += TILE_ROWS) {
        const int r = r0 + k, c = c0 + threadIdx.x;
        if (r < rows && c < cols) tile[k][threadIdx.x] = in[base + (long long)r * cols + c];
    }
    __syncthreads();
    for (int k = threadIdx.y; k < TILE; k += TILE_ROWS) {
        const int c = c0 + k, r = r0 + threadIdx.x;
        if (r < rows && c < cols) out[base + (long long)c * rows + r] = tile[threadIdx.x][k];
    }
}

extern "C" int ntt_transpose(const void* in, void* out, int rows, int cols, int batch,
                             void* stream) {
    if (rows < 1 || cols < 1 || batch < 1 || batch > 65535) return (int)cudaErrorInvalidValue;
    dim3 grid((unsigned int)((cols + TILE - 1) / TILE), (unsigned int)((rows + TILE - 1) / TILE),
              (unsigned int)batch);
    transpose_kernel<<<grid, dim3(TILE, TILE_ROWS), 0, (cudaStream_t)stream>>>(
        (const u64*)in, (u64*)out, rows, cols);
    return (int)cudaGetLastError();
}

// layout 0: contiguous sequences in and out (one launch of a transform);
// 1: columns in and out (the four-step's first launch); 2: contiguous in,
// columns out (its second).  The four-step halves are 2^6 .. 2^11 long.
extern "C" int ntt_local(const void* in, void* out, int log_len, int log_group, int n_seq,
                         int batch, long long batch_stride, int layout, int in_stride,
                         int out_stride, const void* tw, const void* post_tw, int post_stride,
                         unsigned long long scale, int has_scale, unsigned long long w4,
                         unsigned long long w8, unsigned long long w8_3, void* stream) {
    if (log_len < 0 || log_len > MAX_LOG_LEN || log_group < 0 ||
        log_len + log_group > BLOCK_LOG_ELEMS || batch < 1 || batch > 65535 || n_seq < 1 ||
        layout < 0 || layout > 2 || (layout != 0 && log_len < 6))
        return (int)cudaErrorInvalidValue;
#define NTT_ARGS in, out, log_group, n_seq, batch, batch_stride, in_stride, out_stride, tw, \
                 post_tw, post_stride, scale, has_scale, w4, w8, w8_3, stream
#define NTT_CASE(m, in_rows, out_rows) \
    case m:                            \
        return launch_local<m, in_rows, out_rows>(NTT_ARGS);
    if (layout == 0) {
        switch (log_len) {
            NTT_CASE(0, true, true) NTT_CASE(1, true, true) NTT_CASE(2, true, true)
            NTT_CASE(3, true, true) NTT_CASE(4, true, true) NTT_CASE(5, true, true)
            NTT_CASE(6, true, true) NTT_CASE(7, true, true) NTT_CASE(8, true, true)
            NTT_CASE(9, true, true) NTT_CASE(10, true, true) NTT_CASE(11, true, true)
        }
    } else if (layout == 1) {
        switch (log_len) {
            NTT_CASE(6, false, false) NTT_CASE(7, false, false) NTT_CASE(8, false, false)
            NTT_CASE(9, false, false) NTT_CASE(10, false, false) NTT_CASE(11, false, false)
        }
    } else {
        switch (log_len) {
            NTT_CASE(6, true, false) NTT_CASE(7, true, false) NTT_CASE(8, true, false)
            NTT_CASE(9, true, false) NTT_CASE(10, true, false) NTT_CASE(11, true, false)
        }
    }
#undef NTT_CASE
#undef NTT_ARGS
    return (int)cudaErrorInvalidValue;
}
