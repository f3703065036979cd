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
// shared memory is later work. B lanes (the batched form) are one launch,
// the lane from blockIdx.y; one field is one lane.
#include "normal_apply.cuh"

namespace {

// Lane blockIdx.y of B independent applies (fused_normal_apply under vmap;
// one field is B = 1): x, out and the coefficients start that many lanes
// past their base pointers. The offsets are 64-bit (B·9·N floats pass 2^31
// bytes at 4096 lanes of 128²); node indices within a lane stay 32-bit.
struct Lane {
    const float* x;
    float* out;
};

__device__ __forceinline__ Lane lane_of(const float* x, ApplyOp& op, float* out,
                                        size_t n, size_t coeff_per_lane) {
    const size_t b = blockIdx.y;
    op.coeff += b * coeff_per_lane;
    return {x + b * n, out + b * n};
}

// 8 blocks of 256 threads per SM: the lane offsets alone took the 2-D body
// from 32 to 40 registers and 6 resident blocks, 0.87 -> 0.81 of its bytes
// bound at 4096² on the H100.
__global__ void __launch_bounds__(256, 8)
normal_apply_2d(const float* __restrict__ x, ApplyOp op, float* __restrict__ out,
                size_t coeff_per_lane) {
    const int N = op.n0 * op.n1;
    const int idx = blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= N) return;
    const Lane l = lane_of(x, op, out, N, coeff_per_lane);
    l.out[idx] = apply_at(op, l.x, idx / op.n1, idx % op.n1);
}

__global__ void normal_apply_3d(const float* __restrict__ x, ApplyOp op,
                                float* __restrict__ out, size_t coeff_per_lane) {
    const long long N = static_cast<long long>(op.n0) * op.n1 * op.n2;
    const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (idx >= N) return;
    const Lane l = lane_of(x, op, out, N, coeff_per_lane);
    const int i = static_cast<int>(idx);
    const int i2 = i % op.n2, t = i / op.n2;
    l.out[i] = apply_at(op, l.x, t / op.n1, t % op.n1, i2);
}

}  // namespace

// x, out [B, *grid], coeff [B, 3^D, *grid] or [B, *grid] (diag); one field
// is B = 1. ndim 2: (n0, n1) and n2 ignored; ndim 3: (n0, n1, n2).
extern "C" int fi_normal_apply(const float* x, const float* coeff, float* out, int B,
                               int ndim, int n0, int n1, int n2, float w2_0,
                               float w2_1, float w2_2, float w2_3, int diag,
                               void* stream) {
    if ((ndim != 2 && ndim != 3) || B < 1 || B > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    ApplyOp op{coeff, n0, n1, diag, {w2_0, w2_1, w2_2, w2_3}, ndim == 3 ? n2 : 1};
    const long long N = static_cast<long long>(n0) * n1 * op.n2;
    const size_t per = static_cast<size_t>(N) * (diag ? 1 : (ndim == 3 ? 27 : 9));
    const int threads = 256;
    const dim3 blocks(static_cast<unsigned>((N + threads - 1) / threads),
                      static_cast<unsigned>(B));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (ndim == 2)
        normal_apply_2d<<<blocks, threads, 0, s>>>(x, op, out, per);
    else
        normal_apply_3d<<<blocks, threads, 0, s>>>(x, op, out, per);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fi_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
