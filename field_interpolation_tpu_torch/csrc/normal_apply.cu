// fused_normal_apply for Hopper: out = (S + DᵀWD) x on a 2-D or 3-D grid in
// one pass.
//
// Replaces three TPU kernels of field_interpolation_tpu/ops/pallas_stencil.py
// that compute the same function and differ only in how they tile VMEM:
// fused_normal_apply (170, whole array, 2-D and 3-D), fused_normal_apply_
// striped (300, axis-0 stripes) and fused_normal_apply_striped2_3d (1662,
// axis-0/1 tiles). On the H100 no tiling is needed to fit a block's memory:
// every node reads its neighbours from global memory through L1/L2.
//
// What bounds it on the H100: memory. Per node it reads 3^D coefficient
// planes (9 in 2-D, 27 in 3-D: 108 B/node) and writes one float; x is reread
// by neighbouring threads from L1/L2. At 256² the 2.6 MB working set sits in
// the 50 MB L2; at 128³ the 226 MB coefficient tensor streams from HBM once
// per apply (~68 µs at 3.35 TB/s), so the 3-D apply is HBM-bound.
// What the design does about it: one thread per node in gather form (no
// write conflicts, no atomics), coalesced along the minor axis, the stencil
// recomputed on the fly instead of staging y in shared memory. Tiling x in
// shared memory is later work.
#include "normal_apply.cuh"

namespace {

__global__ void normal_apply_2d(const float* __restrict__ x, ApplyOp op,
                                float* __restrict__ out) {
    const int N = op.n0 * op.n1;
    const int idx = blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= N) return;
    out[idx] = apply_at(op, x, idx / op.n1, idx % op.n1);
}

__global__ void normal_apply_3d(const float* __restrict__ x, ApplyOp op,
                                float* __restrict__ out) {
    const long long N = static_cast<long long>(op.n0) * op.n1 * op.n2;
    const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (idx >= N) return;
    const int i = static_cast<int>(idx);
    const int i2 = i % op.n2, t = i / op.n2;
    out[i] = apply_at(op, x, t / op.n1, t % op.n1, i2);
}

}  // namespace

// ndim 2: (n0, n1) and n2 ignored; ndim 3: (n0, n1, n2).
extern "C" int fi_normal_apply(const float* x, const float* coeff, float* out,
                               int ndim, int n0, int n1, int n2, float w2_0,
                               float w2_1, float w2_2, float w2_3, int diag,
                               void* stream) {
    if (ndim != 2 && ndim != 3) return static_cast<int>(cudaErrorInvalidValue);
    ApplyOp op{coeff, n0, n1, diag, {w2_0, w2_1, w2_2, w2_3}, ndim == 3 ? n2 : 1};
    const long long N = static_cast<long long>(n0) * n1 * op.n2;
    const int threads = 256;
    const unsigned blocks = static_cast<unsigned>((N + threads - 1) / threads);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (ndim == 2)
        normal_apply_2d<<<blocks, threads, 0, s>>>(x, op, out);
    else
        normal_apply_3d<<<blocks, threads, 0, s>>>(x, op, out);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fi_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
