// One smoothing sweep for Hopper on a 2-D or 3-D grid, A = S + DᵀWD with the
// full 3^D data stencil or a diagonal one, in one of two modes:
//   damped Jacobi:  z_out = z + sid·(r − A z)                      (sid = τ·D⁻¹)
//   Chebyshev:      z_out = z + c1_k·(z − z_prev) + c2_k·sid·(r − A z)  (sid = D⁻¹)
// with (c1_k, c2_k) row k of the [ν, 2] schedule, read from device memory.
//
// Replaces these TPU kernels of field_interpolation_tpu/ops/pallas_stencil.py:
// fused_smooth (513), in its Jacobi form (→ 559) and its Chebyshev form
// (→ 537, body _cheb_inplace 483-507): ν sweeps on a whole-VMEM level, which
// the wrapper runs as ν launches of this kernel on diagonal-data levels and
// 3-D full-data levels (2-D full-data levels go to jacobi_multisweep2d.cu);
// fused_sweep_striped2_3d (1813: one Jacobi sweep on a 3-D diagonal-data
// level too large for VMEM, tiled over axes 0/1) and fused_sweep_striped_diag
// (1959: the same on a 2-D diagonal-data level, axis-0 stripes), each one
// launch. The reference runs Chebyshev on those two levels as Jacobi
// launches plus two XLA axpys per sweep (its multigrid.py:917-931); here the
// Chebyshev mode does the whole update in the one launch.
//
// Out of place: the TPU kernels update z inside one sequential program; on
// the H100 the blocks of a launch run in no order, so an in-place update
// would let one block read neighbours another block already moved. The
// wrapper ping-pongs two buffers, one launch per sweep (the launch boundary
// is the barrier between sweeps). z == nullptr means z = 0, so the sweep is
// z_out = sid·r (Jacobi; Chebyshev: c2_k·sid·r): the reference's from-zero
// first sweep (pallas_stencil.py:549-550, 491-497), which reads neither A
// nor z. z_prev == nullptr means z_prev = 0. Chebyshev needs no third
// buffer: z_out may be the buffer that holds z_prev, since each thread
// reads z_prev only at its own node, before it writes z_out there, and
// neighbours are read from z alone (hence no __restrict__ on those two).
//
// What bounds it on the H100: memory. Per node one Jacobi sweep reads r,
// sid, z and the data term (one plane in diagonal form: 16 B/node, ~34 MB at
// 128³; 27 planes in full form: 120 B/node) and writes z_out; Chebyshev reads
// z_prev too (20 B/node diagonal). Neighbouring z values come from L1/L2.
// What the design does about it: one thread per node in gather form,
// coalesced along the minor axis, A recomputed on the fly from the shared
// apply_at, the schedule row read once per thread from L2.
#include "normal_apply.cuh"

namespace {

template <int D, bool kCheb>
__global__ void jacobi_sweep_kernel(const float* __restrict__ r,
                                    const float* __restrict__ z,
                                    const float* __restrict__ sid, ApplyOp op,
                                    const float* zprev, const float* __restrict__ cf,
                                    int k, float* zout) {
    const long long N = static_cast<long long>(op.n0) * op.n1 * (D == 3 ? op.n2 : 1);
    const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (idx >= N) return;
    const int i = static_cast<int>(idx);
    const float c2 = kCheb ? cf[2 * k + 1] : 1.f;
    if (z == nullptr) {
        zout[i] = c2 * (sid[i] * r[i]);
        return;
    }
    float az;
    if (D == 2) {
        az = apply_at(op, z, i / op.n1, i % op.n1);
    } else {
        const int i2 = i % op.n2, t = i / op.n2;
        az = apply_at(op, z, t / op.n1, t % op.n1, i2);
    }
    const float zi = z[i];
    if (kCheb) {
        const float zp = zprev == nullptr ? 0.f : zprev[i];
        zout[i] = zi + (cf[2 * k] * (zi - zp) + c2 * (sid[i] * (r[i] - az)));
    } else {
        zout[i] = zi + sid[i] * (r[i] - az);
    }
}

template <int D>
void launch_sweep(unsigned blocks, int threads, cudaStream_t s, const float* r,
                  const float* z, const float* sid, const ApplyOp& op, const float* zprev,
                  const float* cf, int k, float* zout) {
    if (cf == nullptr)
        jacobi_sweep_kernel<D, false><<<blocks, threads, 0, s>>>(r, z, sid, op, zprev, cf, k,
                                                                 zout);
    else
        jacobi_sweep_kernel<D, true><<<blocks, threads, 0, s>>>(r, z, sid, op, zprev, cf, k,
                                                                zout);
}

}  // namespace

// z may be null (sweep from zero); ndim 2: (n0, n1), n2 ignored. cf null:
// damped Jacobi; else the [ν, 2] Chebyshev schedule on the device, k the
// row of this sweep and zprev z_prev (null: zeros; it may be zout).
extern "C" int fi_jacobi_sweep(const float* r, const float* z, const float* coeff,
                               const float* sid, float* zout, int ndim, int n0,
                               int n1, int n2, float w2_0, float w2_1, float w2_2,
                               float w2_3, int diag, const float* zprev, const float* cf,
                               int k, void* stream) {
    if (ndim != 2 && ndim != 3) return static_cast<int>(cudaErrorInvalidValue);
    if (cf != nullptr && k < 0) return static_cast<int>(cudaErrorInvalidValue);
    ApplyOp op{coeff, n0, n1, diag, {w2_0, w2_1, w2_2, w2_3}, ndim == 3 ? n2 : 1};
    const long long N = static_cast<long long>(n0) * n1 * op.n2;
    const int threads = 256;
    const unsigned blocks = static_cast<unsigned>((N + threads - 1) / threads);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (ndim == 2)
        launch_sweep<2>(blocks, threads, s, r, z, sid, op, zprev, cf, k, zout);
    else
        launch_sweep<3>(blocks, threads, s, r, z, sid, op, zprev, cf, k, zout);
    return static_cast<int>(cudaGetLastError());
}
