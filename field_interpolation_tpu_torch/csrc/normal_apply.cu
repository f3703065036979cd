// fused_normal_apply for Hopper: out = (S + DᵀWD) x on a 2-D grid in one pass.
//
// Replaces field_interpolation_tpu/ops/pallas_stencil.py:fused_normal_apply
// (lines 170-183, body _kernel_body 104-166).
//
// What bounds it on the H100: memory. Per node it reads 9 coefficient
// planes (36 B) and writes one float; x is reread by neighbouring threads
// from L1/L2. At 256² the 2.6 MB working set sits in the 50 MB L2, so the
// kernel is bound by launch latency and L2 bandwidth, not by HBM.
// What the design does about it: one thread per node in gather form (no
// write conflicts, no atomics), coalesced along the minor axis, the stencil
// recomputed on the fly instead of staging y in shared memory. Tiling x in
// shared memory is later work.
#include "normal_apply.cuh"

namespace {

__global__ void normal_apply_kernel(const float* __restrict__ x, ApplyOp op,
                                    float* __restrict__ out) {
    const int N = op.n0 * op.n1;
    const int idx = blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= N) return;
    out[idx] = apply_at(op, x, idx / op.n1, idx % op.n1);
}

}  // namespace

extern "C" int fi_normal_apply(const float* x, const float* coeff, float* out,
                               int n0, int n1, float w2_0, float w2_1,
                               float w2_2, float w2_3, int diag, void* stream) {
    ApplyOp op{coeff, n0, n1, diag, {w2_0, w2_1, w2_2, w2_3}};
    const int threads = 256;
    const int blocks = (n0 * n1 + threads - 1) / threads;
    normal_apply_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        x, op, out);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fi_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
