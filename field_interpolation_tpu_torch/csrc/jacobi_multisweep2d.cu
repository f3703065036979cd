// Several smoothing sweeps per launch for Hopper on a 2-D grid, A = S + DᵀWD
// with the full 9-channel data stencil, in one of two modes:
//   damped Jacobi:  ν times z ← z + sid·(r − A z)                      (sid = τ·D⁻¹)
//   Chebyshev:      ν times z ← z + c1_k·(z − z_prev) + c2_k·sid·(r − A z)  (sid = D⁻¹)
// with (c1_k, c2_k) row k of the [ν, 2] schedule, read from device memory.
//
// Replaces the TPU kernels of field_interpolation_tpu/ops/pallas_stencil.py
// that run all ν sweeps of a smoothing phase in one pass with the 9-channel
// coefficients read once: fused_smooth_striped (653, axis-0 stripes) and
// fused_smooth_tiled (876, tiles on both axes), each with its Chebyshev mode
// (689-750, 921-991), and the 2-D full-data form of fused_smooth (513, the
// whole level in one program; Chebyshev 537).
//
// What bounds it on the H100: memory. One sweep needs per node 9
// coefficients, r, sid and z (48 B) and writes z (4 B): ν one-sweep launches
// move ν·52 B/node, one launch of this kernel 52 B/node plus the halo it
// reads twice (from L2 where the neighbouring tile was just read); Chebyshev
// reads z_prev too, and writes it where a phase takes more than one launch.
//
// What the design does about it. Each block owns an output tile and loads it
// once with a halo of h = n·ρ nodes on every side (n = the sweeps that read
// neighbours, ρ = the operator radius): 64 × 32 nodes in all, so the output
// tile is (64 − 2h) × (32 − 2h). The tile's coefficients, r and sid stay in
// shared memory, and z in two shared buffers (an in-place update would race
// inside a block too), with a barrier between sweeps: 104 KB a block, so two
// blocks share an SM and one's loads overlap the other's sweeps. After sweep
// s the values are still exact s·ρ nodes in from the tile's edge, so sweep s
// updates only those, and the output is the part h nodes in. Edges are
// global: halo nodes outside the grid hold z = 0 and are never updated, and
// the smoothness windows and data pairs are normal_apply.cuh's, evaluated
// with the node's global index and extent and tile-local addresses. With
// z == nullptr the first sweep is z = sid·r (Chebyshev: c2_0·sid·r; the
// reference's from-zero step, pallas_stencil.py:705-711), reads no
// neighbours and so needs no halo. Chebyshev's z_prev is read only at a
// node's own index, so it stays in registers beside z (no shared memory:
// the 104 KB and two blocks per SM stay); the launch that leaves sweeps for
// a next launch writes z_prev out for it.
#include "normal_apply.cuh"

namespace {

constexpr int kEX = 64;                 // tile columns = blockDim.x
constexpr int kBY = 8;                  // blockDim.y
constexpr int kRows = 4;                // tile rows per thread
constexpr int kEY = kBY * kRows;        // 32 tile rows
constexpr int kTile = kEY * kEX;
constexpr int kMaxHalo = 8;             // the output tile keeps ≥ 16 × 48 nodes
// 9 coefficient planes, r, sid and two z buffers per tile node.
constexpr size_t kSmemBytes = 13 * kTile * sizeof(float);

// zprev: z_prev at the launch's start (null: zeros); kr: the schedule row
// of the first sweep that reads neighbours; zprev_out: where z_prev is
// left for the next launch (null: not wanted). Jacobi ignores all three.
template <bool kCheb>
__global__ void __launch_bounds__(kEX * kBY, 2)
jacobi_multisweep2d_kernel(const float* __restrict__ r, const float* __restrict__ z,
                           const float* __restrict__ sid, ApplyOp op, int rho,
                           int sweeps, int halo, const float* __restrict__ zprev,
                           const float* __restrict__ cf, int kr,
                           float* __restrict__ zprev_out, float* __restrict__ out) {
    extern __shared__ float smem[];
    float* cs = smem;                    // [9][kTile]
    float* rs = smem + 9 * kTile;
    float* ss = rs + kTile;
    float* zs = ss + kTile;              // two z buffers: zs, zs + kTile
    const int n0 = op.n0, n1 = op.n1, N = n0 * n1;
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int g0 = blockIdx.y * (kEY - 2 * halo) - halo;  // global origin of the tile
    const int j = blockIdx.x * (kEX - 2 * halo) - halo + tx;
    const bool col_in = j >= 0 && j < n1;
    // The from-zero step is schedule row kr − 1 (row 0).
    const float c2z = kCheb && z == nullptr ? cf[2 * (kr - 1) + 1] : 1.f;

    float zv[kRows], zpv[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
        const int a = ty + k * kBY, i = g0 + a, l = a * kEX + tx;
        const bool in = col_in && i >= 0 && i < n0;
        const int flat = in ? i * n1 + j : 0;
        const float rv = in ? r[flat] : 0.f, sv = in ? sid[flat] : 0.f;
        rs[l] = rv;
        ss[l] = sv;
#pragma unroll
        for (int o = 0; o < 9; ++o) cs[o * kTile + l] = in ? op.coeff[o * N + flat] : 0.f;
        zv[k] = !in ? 0.f : (z == nullptr ? c2z * (sv * rv) : z[flat]);
        zs[l] = zv[k];
        if (kCheb) zpv[k] = in && z != nullptr && zprev != nullptr ? zprev[flat] : 0.f;
    }
    __syncthreads();

    for (int s = 1; s <= sweeps; ++s) {
        const int lo = s * rho, hi0 = kEY - lo, hi1 = kEX - lo;
        const float* src = zs + ((s - 1) & 1) * kTile;
        float* dst = zs + (s & 1) * kTile;
        const float c1 = kCheb ? cf[2 * (kr + s - 1)] : 0.f;
        const float c2 = kCheb ? cf[2 * (kr + s - 1) + 1] : 1.f;
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
            const int a = ty + k * kBY, i = g0 + a, l = a * kEX + tx;
            if (col_in && i >= 0 && i < n0 && a >= lo && a < hi0 && tx >= lo && tx < hi1) {
                const float az = smooth_at(op.w2, src, l, i, j, n0, n1, kEX)
                    + data_at([&](int o) { return cs[o * kTile + l]; }, src, l, i, j,
                              n0, n1, kEX);
                if (kCheb) {
                    const float zn = zv[k] + (c1 * (zv[k] - zpv[k]) + c2 * (ss[l] * (rs[l] - az)));
                    zpv[k] = zv[k];
                    zv[k] = zn;
                } else {
                    zv[k] += ss[l] * (rs[l] - az);
                }
            }
            dst[l] = zv[k];
        }
        __syncthreads();
    }

    if (!col_in || tx < halo || tx >= kEX - halo) return;
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
        const int a = ty + k * kBY, i = g0 + a;
        if (i >= 0 && i < n0 && a >= halo && a < kEY - halo) {
            out[i * n1 + j] = zv[k];
            if (kCheb && zprev_out != nullptr) zprev_out[i * n1 + j] = zpv[k];
        }
    }
}

template <bool kCheb>
cudaError_t launch_multisweep(dim3 blocks, dim3 threads, cudaStream_t s, const float* r,
                              const float* z, const float* sid, const ApplyOp& op, int rho,
                              int reading, int halo, const float* zprev, const float* cf,
                              int kr, float* zprev_out, float* out) {
    // Above 48 KB of shared memory a block needs the opt-in (per device, so
    // set at every launch; it costs no device work).
    cudaError_t err = cudaFuncSetAttribute(jacobi_multisweep2d_kernel<kCheb>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return err;
    jacobi_multisweep2d_kernel<kCheb><<<blocks, threads, kSmemBytes, s>>>(
        r, z, sid, op, rho, reading, halo, zprev, cf, kr, zprev_out, out);
    return cudaGetLastError();
}

}  // namespace

// The halo the kernel is built for; the wrapper reads it to split a longer
// smoothing phase into several launches.
extern "C" int fi_jacobi_multisweep2d_max_halo() { return kMaxHalo; }

// `sweeps` ≥ 1 sweeps; z null: the first is the from-zero step. The sweeps
// that read neighbours times rho must fit the halo (≤ kMaxHalo). cf null:
// damped Jacobi; else the [ν, 2] Chebyshev schedule on the device, k0 the
// row of this launch's first sweep (the from-zero step's is 0), zprev
// z_prev at the start (null: zeros) and zprev_out, where wanted, z_prev at
// the end.
extern "C" int fi_jacobi_multisweep2d(const float* r, const float* z, const float* coeff,
                                      const float* sid, float* out, int n0, int n1,
                                      float w2_0, float w2_1, float w2_2, float w2_3,
                                      int rho, int sweeps, const float* zprev,
                                      const float* cf, int k0, float* zprev_out,
                                      void* stream) {
    const int reading = z == nullptr ? sweeps - 1 : sweeps;
    const int halo = reading * rho;
    if (sweeps < 1 || rho < 1 || halo > kMaxHalo || n0 < 1 || n1 < 1 || k0 < 0
        || (z == nullptr && k0 != 0))
        return static_cast<int>(cudaErrorInvalidValue);
    ApplyOp op{coeff, n0, n1, 0, {w2_0, w2_1, w2_2, w2_3}, 1};
    const dim3 threads(kEX, kBY);
    const dim3 blocks((n1 + kEX - 2 * halo - 1) / (kEX - 2 * halo),
                      (n0 + kEY - 2 * halo - 1) / (kEY - 2 * halo));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int kr = z == nullptr ? k0 + 1 : k0;
    const cudaError_t err =
        cf == nullptr
            ? launch_multisweep<false>(blocks, threads, s, r, z, sid, op, rho, reading, halo,
                                       zprev, cf, kr, zprev_out, out)
            : launch_multisweep<true>(blocks, threads, s, r, z, sid, op, rho, reading, halo,
                                      zprev, cf, kr, zprev_out, out);
    return static_cast<int>(err);
}
