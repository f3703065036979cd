// One damped-Jacobi sweep for Hopper: z_out = z + sid·(r − A z) on a 2-D or
// 3-D grid, A = S + DᵀWD with the full 3^D data stencil or a diagonal one.
//
// Replaces two TPU kernels of field_interpolation_tpu/ops/pallas_stencil.py:
// fused_smooth, Jacobi form (513 → 559: ν sweeps on a whole-VMEM level, full
// or diagonal data), which the wrapper runs as ν launches of this kernel,
// and fused_sweep_striped2_3d (1813: one sweep on a 3-D diagonal-data level
// too large for VMEM, tiled over axes 0/1), which is one launch.
//
// Out of place: the TPU kernels update z inside one sequential program; on
// the H100 the blocks of a launch run in no order, so an in-place update
// would let one block read neighbours another block already moved. The
// wrapper ping-pongs two buffers, one launch per sweep (the launch boundary
// is the barrier between sweeps). z == nullptr means z = 0, so the sweep is
// z_out = sid·r: the reference's from-zero first sweep (pallas_stencil.py:
// 549-550), which reads neither A nor z.
//
// What bounds it on the H100: memory. Per node one sweep reads r, sid, z and
// the data term (one plane in diagonal form: 16 B/node, ~34 MB at 128³;
// 27 planes in full form: 120 B/node) and writes z_out; neighbouring z
// values come from L1/L2. What the design does about it: one thread per node
// in gather form, coalesced along the minor axis, A recomputed on the fly
// from the shared apply_at. Fusing the ν sweeps of a level into one launch
// (shared-memory tiles with halos) is later work.
#include "normal_apply.cuh"

namespace {

template <int D>
__global__ void jacobi_sweep_kernel(const float* __restrict__ r,
                                    const float* __restrict__ z,
                                    const float* __restrict__ sid, ApplyOp op,
                                    float* __restrict__ zout) {
    const long long N = static_cast<long long>(op.n0) * op.n1 * (D == 3 ? op.n2 : 1);
    const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (idx >= N) return;
    const int i = static_cast<int>(idx);
    if (z == nullptr) {
        zout[i] = sid[i] * r[i];
        return;
    }
    float az;
    if (D == 2) {
        az = apply_at(op, z, i / op.n1, i % op.n1);
    } else {
        const int i2 = i % op.n2, t = i / op.n2;
        az = apply_at(op, z, t / op.n1, t % op.n1, i2);
    }
    zout[i] = z[i] + sid[i] * (r[i] - az);
}

}  // namespace

// z may be null (sweep from zero); ndim 2: (n0, n1), n2 ignored.
extern "C" int fi_jacobi_sweep(const float* r, const float* z, const float* coeff,
                               const float* sid, float* zout, int ndim, int n0,
                               int n1, int n2, float w2_0, float w2_1, float w2_2,
                               float w2_3, int diag, void* stream) {
    if (ndim != 2 && ndim != 3) return static_cast<int>(cudaErrorInvalidValue);
    ApplyOp op{coeff, n0, n1, diag, {w2_0, w2_1, w2_2, w2_3}, ndim == 3 ? n2 : 1};
    const long long N = static_cast<long long>(n0) * n1 * op.n2;
    const int threads = 256;
    const unsigned blocks = static_cast<unsigned>((N + threads - 1) / threads);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (ndim == 2)
        jacobi_sweep_kernel<2><<<blocks, threads, 0, s>>>(r, z, sid, op, zout);
    else
        jacobi_sweep_kernel<3><<<blocks, threads, 0, s>>>(r, z, sid, op, zout);
    return static_cast<int>(cudaGetLastError());
}
