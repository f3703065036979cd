// One smoothing phase for Hopper on a 2-D or 3-D grid, A = S + DᵀWD with the
// full 3^D data stencil or a diagonal one: ν sweeps of
//   damped Jacobi:  z⁺ = z + sid·(r − A z)                        (sid = τ·D⁻¹)
//   Chebyshev:      z⁺ = z + c1_k·(z − z_prev) + c2_k·sid·(r − A z)  (sid = D⁻¹)
// ((c1_k, c2_k) row k of the [ν, 2] schedule, read from device memory), from
// zero or from a given z, and where the caller asks the level's residual
// r − A z_ν, the one the multigrid cycle restricts next: all of it in one
// host call, fi_smooth_phase, which enqueues one launch per dependent step.
//
// Replaces these TPU kernels of field_interpolation_tpu/ops/pallas_stencil.py:
// fused_smooth (513), in its Jacobi form (→ 559) and its Chebyshev form
// (→ 537, body _cheb_inplace 483-507): ν sweeps on a whole-VMEM level, here
// on diagonal-data levels and 3-D full-data levels (2-D full-data levels go
// to jacobi_multisweep2d.cu); fused_sweep_striped2_3d (1813: one Jacobi
// sweep on a 3-D diagonal-data level too large for VMEM, tiled over axes
// 0/1) and fused_sweep_striped_diag (1959: the same on a 2-D diagonal-data
// level, axis-0 stripes). The reference runs Chebyshev on those two levels
// as Jacobi launches plus two XLA axpys per sweep (its multigrid.py:917-931),
// and every residual of its cycle in XLA; here both are part of the phase.
//
// The steps. The TPU kernels update z in place inside one sequential
// program; on the H100 the blocks of a launch run in no order, so a sweep
// reads the previous sweep's z from another buffer, and the launch boundary
// is the barrier between sweeps: the outputs alternate between zout and tmp
// so that the last lands in zout. Chebyshev needs no third buffer: z⁺ may be
// written over the buffer that holds z_prev, since a thread reads z_prev only
// at its own node, before it writes z⁺ there. The from-zero step
// z₁ = c·sid·r (c = 1 Jacobi, c2_0 Chebyshev; pallas_stencil.py:549-550,
// 491-497) reads no neighbours, so it is no launch of its own: the next step
// computes z₁ where it loads its tile, and the Chebyshev sweep after that
// recomputes it at its own node as z_prev. The residual is one more step,
// after the last sweep. ν = 3 from zero with the residual takes 3 launches,
// from z 4; before, the phase took ν launches and ν host calls, and the
// cycle's residual about thirty launches of plain torch.
//
// The body. A block of 32 × 8 threads owns a tile of output nodes (3-D:
// 4 planes × 8 rows × 32 columns; 2-D: 32 rows × 32 columns), indexed by
// blockIdx and threadIdx on each axis. It loads the tile's z (or z₁) with a
// halo of ρ nodes into shared memory once, ρ ≤ 3 being the operator's
// radius (its largest active smoothness order; 1 at least with a full data
// stencil) and a template parameter, so the tile's extents are constants
// and the load's index arithmetic has no division. A z at each node comes
// from the tile through normal_apply.cuh's apply_at on the tile's strides;
// the windows and data pairs are bounded by the node's global index, so a
// tile edge inside the grid is no boundary. r, sid, z_prev and the data term
// are read at the node itself; the 3^D channels are planes of the grid, so
// each channel is one coalesced row of 32 floats per warp. Against a body
// that reads the neighbours through L1 (one thread per node, no tile), the
// tile won at 128³, 64³ and 2048²; with its extents known only at run time
// it lost at 128³ (a comparison made on the H100 while choosing the tile).
//
// What bounds it on the H100: memory. Per node one sweep reads r, sid, the
// data term (one plane in diagonal form, 27 in 3-D full form) and z, and
// writes z⁺: 20 B/node diagonal, 42 MB at 128³ (12.5 µs at 3.35 TB/s), 124
// B/node with 27 channels; Chebyshev reads z_prev too. The residual step
// moves 16 B/node. The tile's halo is read from L2 (z at 128³ is 8 MB):
// about 3.4 loads per node at ρ = 2 in 3-D, 1.3 in 2-D. On the multigrid's
// coarse levels a step is a few µs of launch latency whatever it moves, so
// the number of steps per phase, not the bytes, bounds those.
//
// Lanes (the same kernels under vmap, the batched cycle's smoothing phases):
// B independent phases in the launches of one, each step one launch for all
// lanes. Lane b's arrays (r, z, z_prev, the outputs, sid, the data term and
// the schedule) start b lanes past lane 0's, with 64-bit lane offsets and
// 32-bit node indices within a lane, as normal_apply.cu's lanes. The lane is
// folded into blockIdx.x (lane · tiles + tile along the minor axis), whose
// limit is 2³¹ − 1: in 3-D blockIdx.z already counts the 4-plane tiles, so
// 4096 lanes of 128³ (32 of them) would pass gridDim.z's 65,535. The lane
// offsets are a template parameter (kLanes), so one field (B = 1) runs the
// kernel without them. A lane's arithmetic is the single field's, so its
// output is the same bits.
#include "normal_apply.cuh"

namespace {

constexpr int kTX = 32;      // threads along the minor axis
constexpr int kTY = 8;       // threads along the next axis
constexpr int kPlanes = 4;   // 3-D: axis-0 planes per tile, one per pass of a thread
constexpr int kRows = 4;     // 2-D: rows per thread, kTY apart
constexpr int kMaxHalo = 3;  // the widest stencil: order-3 smoothness

enum Mode { kJacobi, kChebyshev, kResidual };
enum Prev { kPrevMemory, kPrevZero, kPrevFromZero };  // where z_prev comes from

// The operands every step of a phase shares (lane 0's).
struct Phase {
    const float* r;
    const float* sid;
    const float* cf;  // the Chebyshev schedule; null: damped Jacobi
    ApplyOp op;
    int halo;
    size_t lane_nodes;  // floats a lane of r, sid, z and the outputs
    size_t lane_coeff;  // floats a lane of the data term
    int lane_cf;        // floats a lane of the schedule
    int tiles;          // blocks a lane along the minor axis: blockIdx.x = lane·tiles + tile
    int lanes;
};

// One step. z: the z that the step reads, or null for z₁ = c·sid·r computed
// on the fly. kJacobi / kChebyshev write z⁺ to zout (Chebyshev: z_prev from
// zprev, zeros, or z₁ at the node, by `prev`; schedule row k). kResidual
// writes r − A z to res where res is not null, and z₁ to zout where z is
// null. zout may be zprev, so neither carries __restrict__. kHalo is the
// operator's radius, a template parameter so that the tile's extents are
// constants and the load's index arithmetic is multiplies and shifts.
template <int D, int kMode, int kHalo, bool kLanes>
__global__ void __launch_bounds__(kTX * kTY)
smooth_phase_kernel(Phase ph, const float* z, const float* zprev, int prev, int k,
                    float* zout, float* __restrict__ res) {
    // The tile, halo included; 2-D uses axes 1 and 2 only.
    constexpr int e0 = D == 3 ? kPlanes + 2 * kHalo : 1;
    constexpr int e1 = (D == 3 ? kTY : kTY * kRows) + 2 * kHalo;
    constexpr int e2 = kTX + 2 * kHalo;
    constexpr int h0 = D == 3 ? kHalo : 0;
    __shared__ float tile[e0 * e1 * e2];
    // The block's lane, and its arrays.
    const int lane = kLanes ? blockIdx.x / ph.tiles : 0;
    const size_t at = lane * ph.lane_nodes;
    ApplyOp op = ph.op;
    op.coeff += lane * ph.lane_coeff;
    const float* r = ph.r + at;
    const float* sid = ph.sid + at;
    const float* cf = ph.cf == nullptr ? nullptr : ph.cf + static_cast<size_t>(lane) * ph.lane_cf;
    if (z != nullptr) z += at;
    if (zprev != nullptr) zprev += at;
    if (zout != nullptr) zout += at;
    if (res != nullptr) res += at;
    const int tx = threadIdx.x, ty = threadIdx.y;
    const float c0 = cf == nullptr ? 1.f : cf[1];  // z₁ = c0·sid·r
    const int n0 = D == 3 ? op.n0 : 1;
    const int n1 = D == 3 ? op.n1 : op.n0;
    const int n2 = D == 3 ? op.n2 : op.n1;
    const int o0 = D == 3 ? blockIdx.z * kPlanes : 0;
    const int o1 = blockIdx.y * (D == 3 ? kTY : kTY * kRows);
    const int o2 = (blockIdx.x - lane * ph.tiles) * kTX;
    for (int t = ty * kTX + tx; t < e0 * e1 * e2; t += kTX * kTY) {
        const int a2 = t % e2, a1 = (t / e2) % e1, a0 = t / (e1 * e2);
        const int g0 = o0 - h0 + a0, g1 = o1 - kHalo + a1, g2 = o2 - kHalo + a2;
        float v = 0.f;  // outside the grid: never read
        if (g0 >= 0 && g0 < n0 && g1 >= 0 && g1 < n1 && g2 >= 0 && g2 < n2) {
            const int g = (g0 * n1 + g1) * n2 + g2;
            v = z != nullptr ? z[g] : c0 * (sid[g] * r[g]);
        }
        tile[t] = v;
    }
    __syncthreads();
    constexpr int passes = D == 3 ? kPlanes : kRows;
#pragma unroll 1
    for (int p = 0; p < passes; ++p) {
        const int i0 = o0 + (D == 3 ? p : 0);
        const int i1 = o1 + ty + (D == 3 ? 0 : kTY * p);
        const int i2 = o2 + tx;
        if (i0 >= n0 || i1 >= n1 || i2 >= n2) continue;
        const int g = (i0 * n1 + i1) * n2 + i2;
        const int t = ((i0 - o0 + h0) * e1 + (i1 - o1 + kHalo)) * e2 + (i2 - o2 + kHalo);
        const float zi = tile[t];
        if (kMode == kResidual) {
            if (z == nullptr && zout != nullptr) zout[g] = zi;
            if (res == nullptr) continue;
        }
        const float az = D == 3 ? apply_at(op, tile, t, e1 * e2, e2, g, i0, i1, i2)
                                : apply_at(op, tile, t, e2, g, i1, i2);
        const float ri = r[g];
        if (kMode == kResidual) {
            res[g] = ri - az;
        } else if (kMode == kJacobi) {
            zout[g] = zi + sid[g] * (ri - az);
        } else {
            const float zp = prev == kPrevMemory ? zprev[g]
                             : prev == kPrevZero ? 0.f
                                                 : c0 * (sid[g] * ri);
            zout[g] = zi + (cf[2 * k] * (zi - zp) + cf[2 * k + 1] * (sid[g] * (ri - az)));
        }
    }
}

template <int D, int kHalo, bool kLanes>
void launch_kernel(int mode, const Phase& ph, cudaStream_t s, const float* z,
                   const float* zprev, int prev, int k, float* zout, float* res) {
    const dim3 block(kTX, kTY);
    const unsigned x = static_cast<unsigned>(ph.tiles) * static_cast<unsigned>(ph.lanes);
    const dim3 grid = D == 3 ? dim3(x, (ph.op.n1 + kTY - 1) / kTY, (ph.op.n0 + kPlanes - 1) / kPlanes)
                             : dim3(x, (ph.op.n0 + kTY * kRows - 1) / (kTY * kRows));
    if (mode == kJacobi)
        smooth_phase_kernel<D, kJacobi, kHalo, kLanes><<<grid, block, 0, s>>>(
            ph, z, zprev, prev, k, zout, res);
    else if (mode == kChebyshev)
        smooth_phase_kernel<D, kChebyshev, kHalo, kLanes><<<grid, block, 0, s>>>(
            ph, z, zprev, prev, k, zout, res);
    else
        smooth_phase_kernel<D, kResidual, kHalo, kLanes><<<grid, block, 0, s>>>(
            ph, z, zprev, prev, k, zout, res);
}

template <int D, bool kLanes>
void launch_halo(int mode, const Phase& ph, cudaStream_t s, const float* z,
                 const float* zprev, int prev, int k, float* zout, float* res) {
    switch (ph.halo) {
        case 0: launch_kernel<D, 0, kLanes>(mode, ph, s, z, zprev, prev, k, zout, res); break;
        case 1: launch_kernel<D, 1, kLanes>(mode, ph, s, z, zprev, prev, k, zout, res); break;
        case 2: launch_kernel<D, 2, kLanes>(mode, ph, s, z, zprev, prev, k, zout, res); break;
        default: launch_kernel<D, 3, kLanes>(mode, ph, s, z, zprev, prev, k, zout, res); break;
    }
}

template <int D>
cudaError_t launch_step(int mode, const Phase& ph, cudaStream_t s, const float* z,
                        const float* zprev, int prev, int k, float* zout, float* res) {
    if (ph.lanes > 1)
        launch_halo<D, true>(mode, ph, s, z, zprev, prev, k, zout, res);
    else
        launch_halo<D, false>(mode, ph, s, z, zprev, prev, k, zout, res);
    return cudaGetLastError();
}

// The operator's radius: its largest active smoothness order, and 1 for a
// full data stencil.
int operator_radius(const ApplyOp& op) {
    int h = op.diag ? 0 : 1;
    for (int o = 1; o <= kMaxHalo; ++o)
        if (op.w2[o] != 0.f && o > h) h = o;
    return h;
}

}  // namespace

// One smoothing phase of `count` sweeps on an (n0, n1[, n2]) grid (ndim 2:
// n2 ignored), and then, where res is not null, res = r − A z_out; on B
// lanes, every array [B, ...] contiguous (one field is B = 1).
// cf null: damped Jacobi; else the [ν, 2] Chebyshev schedule on the device,
// cf_lane floats a lane.
// from_zero: the first of the `count` sweeps is the from-zero step
// z₁ = c·sid·r (z is not read; count ≥ 1); else the sweeps start from z,
// z_prev = z. The phase's z lands in zout (not written when count == 0,
// where z is the phase's z); tmp is a second buffer of the grid's size,
// needed where more than one sweep reads neighbours. *launches: the kernel
// launches enqueued on `stream`. Returns a cudaError_t.
extern "C" int fi_smooth_phase(const float* r, const float* z, const float* coeff,
                               const float* sid, float* zout, float* tmp, float* res,
                               int B, int ndim, int n0, int n1, int n2, float w2_0,
                               float w2_1, float w2_2, float w2_3, int diag, const float* cf,
                               int cf_lane, int count, int from_zero, int* launches,
                               void* stream) {
    *launches = 0;
    const int steps = count - (from_zero ? 1 : 0);  // sweeps that read neighbours
    if ((ndim != 2 && ndim != 3) || B < 1 || steps < 0 || (steps >= 2 && tmp == nullptr)
        || (count > 0 && zout == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t nodes = static_cast<size_t>(n0) * n1 * (ndim == 3 ? n2 : 1);
    const int minor = ndim == 3 ? n2 : n1;
    Phase ph{r, sid, cf, ApplyOp{coeff, n0, n1, diag, {w2_0, w2_1, w2_2, w2_3},
                                 ndim == 3 ? n2 : 1}, 0,
             nodes, nodes * (diag ? 1 : (ndim == 3 ? 27 : 9)), cf_lane,
             (minor + kTX - 1) / kTX, B};
    if (static_cast<long long>(ph.tiles) * B > 0x7fffffffLL)
        return static_cast<int>(cudaErrorInvalidValue);
    ph.halo = operator_radius(ph.op);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto step = [&](int mode, const float* src, const float* zprev, int prev, int k,
                    float* dst, float* out_res) {
        const cudaError_t err =
            ndim == 3 ? launch_step<3>(mode, ph, s, src, zprev, prev, k, dst, out_res)
                      : launch_step<2>(mode, ph, s, src, zprev, prev, k, dst, out_res);
        if (err == cudaSuccess) ++*launches;
        return err;
    };
    const int sweep = cf == nullptr ? kJacobi : kChebyshev;
    const float* src = from_zero ? nullptr : z;
    const float* prev_buf = z;
    int prev = from_zero ? kPrevZero : kPrevMemory;
    for (int j = 0; j < steps; ++j) {
        float* dst = (steps - 1 - j) % 2 == 0 ? zout : tmp;
        const cudaError_t err = step(sweep, src, prev_buf, prev, j + (from_zero ? 1 : 0),
                                     dst, nullptr);
        if (err != cudaSuccess) return static_cast<int>(err);
        prev = src == nullptr ? kPrevFromZero : kPrevMemory;
        prev_buf = src;
        src = dst;
    }
    cudaError_t err = cudaSuccess;
    if (from_zero && steps == 0)  // z₁ alone, and r − A z₁
        err = step(kResidual, nullptr, nullptr, kPrevZero, 0, zout, res);
    else if (res != nullptr)
        err = step(kResidual, src, nullptr, kPrevZero, 0, nullptr, res);
    return static_cast<int>(err);
}
