// NTT and inverse NTT over Goldilocks for Hopper (sm_90a), natural order in
// and out.
//
// Replaces the JAX package's Pallas kernel
//   ops/ntt_pallas.py::ntt_pallas (_local_stage) -> ntt_local
//
// One kernel, the local transform: each block takes G sequences of
// len = 2^log_len elements, addressed by (sequence, element) strides,
// gathers them into shared memory in bit-reversed order, runs the log_len
// radix-2 stages there (the plain version's butterflies and twiddle tables),
// and writes them back in natural order through output strides, optionally
// times a per-point twiddle and a scale.  The wrapper
// (ops/ntt_cuda.py::ntt_cuda) makes a transform of it:
//   n <= 2^11: one launch, each row a sequence, the inverse's 1/n as the scale;
//   n  > 2^11: the four-step of the TPU kernel, n = n1 * n2 viewed as [n1, n2]:
//     launch 1, the n2 columns as sequences of length n1, each output times
//       w^(i2 * k1) (the inverse's 1/n folded into that table);
//     launch 2, the n1 rows as sequences of length n2, written transposed, so
//       X[k1 + n1 * k2] lands at k2 * n1 + k1: natural order, no extra pass.
// A block's G sequences are neighbours in memory, so where a sequence is
// strided (the columns of launch 1, the transposed write of launch 2)
// neighbouring threads still touch neighbouring addresses, G at a time.
// The shared-memory slot of (element, sequence) is XOR-swizzled so that
// the bit-reversed scatter does not fall on one bank.
//
// What bounds it on this card: each launch reads and writes B * n u64 once
// and spends (n / 2) * log2(len) twiddle multiplies per row: bytes, not
// operations, are the limit (see chip_smoke.py::ntt_bound).
//
// The arithmetic mirrors the plain PyTorch version (ops/ntt.py::_ntt_impl):
// t = odd * w, (even + t, even - t); the values are bit-identical because
// every operation is exact mod p and the four-step is an exact identity.
#include <cuda_runtime.h>

#include "goldilocks.cuh"

#define THREADS 256

__device__ __forceinline__ int swizzle(int a, int shift) { return a ^ ((a >> shift) & 15); }

// Sequence q (< n_seq) of batch row y: element i at
//   in[y * batch_stride + q * in_seq_stride + i * in_elem_stride],
// its transform's element k to
//   out[y * batch_stride + q * out_seq_stride + k * out_elem_stride],
// times post_tw[k * post_k_stride + q * post_seq_stride] if post_tw is given
// and times scale if has_scale.  stage_tw [len - 1]: the twiddles of stage s
// (1-based) at offset 2^(s-1) - 1, 2^(s-1) of them.  Grid: (n_seq / G
// rounded up, batch rows).  Dynamic shared memory: len * G u64.
__global__ void __launch_bounds__(THREADS)
ntt_local_kernel(const u64* __restrict__ in, u64* __restrict__ out, int log_len, int log_group,
                 long long n_seq, long long batch_stride, long long in_seq_stride,
                 long long in_elem_stride, long long out_seq_stride, long long out_elem_stride,
                 const u64* __restrict__ stage_tw, const u64* __restrict__ post_tw,
                 long long post_k_stride, long long post_seq_stride, u64 scale, int has_scale) {
    extern __shared__ u64 sm[];
    const int len = 1 << log_len, group = 1 << log_group, total = len << log_group;
    const int shift = log_len + log_group - 4 > 4 ? log_len + log_group - 4 : 4;
    const long long seq0 = (long long)blockIdx.x << log_group;
    const u64* src = in + blockIdx.y * batch_stride;
    u64* dst = out + blockIdx.y * batch_stride;

    // gather: element i of sequence g to slot rev(i); across the threads the
    // element index runs fastest where a sequence is contiguous, else the
    // sequence index
    const bool in_rows = in_elem_stride == 1;
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
        const int i = in_rows ? (e & (len - 1)) : (e >> log_group);
        const int g = in_rows ? (e >> log_len) : (e & (group - 1));
        if (seq0 + g < n_seq) {
            const int r = log_len ? (int)(__brev((unsigned int)i) >> (32 - log_len)) : 0;
            sm[swizzle((r << log_group) + g, shift)] =
                src[(seq0 + g) * in_seq_stride + i * in_elem_stride];
        }
    }
    __syncthreads();

    // radix-2 stages: pairs (p, p + half) of a group of 2 * half, twiddle j
    for (int s = 1; s <= log_len; ++s) {
        const int half = 1 << (s - 1);
        const u64* tw = stage_tw + (half - 1);
        for (int e = threadIdx.x; e < (total >> 1); e += blockDim.x) {
            const int g = e & (group - 1), b = e >> log_group;
            const int j = b & (half - 1);
            const int p = ((b >> (s - 1)) << s) + j;
            const int lo = swizzle((p << log_group) + g, shift);
            const int hi = swizzle(((p + half) << log_group) + g, shift);
            const u64 even = sm[lo];
            const u64 t = gl_mul(sm[hi], tw[j]);
            sm[lo] = gl_add(even, t);
            sm[hi] = gl_sub(even, t);
        }
        __syncthreads();
    }

    // write back in natural order
    const bool out_rows = out_elem_stride == 1;
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
        const int k = out_rows ? (e & (len - 1)) : (e >> log_group);
        const int g = out_rows ? (e >> log_len) : (e & (group - 1));
        const long long q = seq0 + g;
        if (q < n_seq) {
            u64 v = sm[swizzle((k << log_group) + g, shift)];
            if (post_tw != nullptr) v = gl_mul(v, post_tw[k * post_k_stride + q * post_seq_stride]);
            if (has_scale) v = gl_mul(v, scale);
            dst[q * out_seq_stride + k * out_elem_stride] = v;
        }
    }
}

extern "C" int ntt_local(const void* in, void* out, int log_len, int log_group, long long n_seq,
                         int batch, long long batch_stride, long long in_seq_stride,
                         long long in_elem_stride, long long out_seq_stride,
                         long long out_elem_stride, const void* stage_tw, const void* post_tw,
                         long long post_k_stride, long long post_seq_stride,
                         unsigned long long scale, int has_scale, void* stream) {
    if (log_len < 0 || log_len > 11 || log_group < 0 || log_len + log_group > 12 || batch < 1 ||
        batch > 65535 || n_seq < 1)
        return (int)cudaErrorInvalidValue;
    dim3 grid((unsigned int)((n_seq + (1LL << log_group) - 1) >> log_group), (unsigned int)batch);
    size_t shared_bytes = sizeof(u64) << (log_len + log_group);
    ntt_local_kernel<<<grid, THREADS, shared_bytes, (cudaStream_t)stream>>>(
        (const u64*)in, (u64*)out, log_len, log_group, n_seq, batch_stride, in_seq_stride,
        in_elem_stride, out_seq_stride, out_elem_stride, (const u64*)stage_tw,
        (const u64*)post_tw, post_k_stride, post_seq_stride, (u64)scale, has_scale);
    return (int)cudaGetLastError();
}
