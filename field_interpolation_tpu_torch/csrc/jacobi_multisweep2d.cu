// One smoothing phase for Hopper on a 2-D grid, A = S + DᵀWD with the full
// 9-channel data stencil, in one of two modes:
//   damped Jacobi:  ν times z ← z + sid·(r − A z)                      (sid = τ·D⁻¹)
//   Chebyshev:      ν times z ← z + c1_k·(z − z_prev) + c2_k·sid·(r − A z)  (sid = D⁻¹)
// ((c1_k, c2_k) row k of the [ν, 2] schedule, read from device memory), from
// zero or from a given z, and where the caller asks the level's residual
// r − A z_ν, the one the multigrid cycle restricts next: all of it in one
// host call, fi_multisweep2d_phase, which enqueues one launch, or several
// where the phase reads further than one launch's halo.
//
// Replaces the TPU kernels of field_interpolation_tpu/ops/pallas_stencil.py
// that run all ν sweeps of a smoothing phase in one pass with the 9-channel
// coefficients read once: fused_smooth_striped (653, axis-0 stripes) and
// fused_smooth_tiled (876, tiles on both axes), each with its Chebyshev mode
// (689-750, 921-991), and the 2-D full-data form of fused_smooth (513, the
// whole level in one program; Chebyshev 537). The reference computes the
// residual that follows in XLA.
//
// What bounds it on the H100: by the bytes it must move, memory. The phase
// reads per node the 9 coefficients, r and sid (44 B; from z also z, 4 B)
// and writes z (4 B) and the residual (4 B): 52 B/node from zero with the
// residual, 0.260 ms at 4096² at 3.35 TB/s; 56 B/node from z with it.
// Chebyshev with a phase split over launches also reads and writes z_prev
// between them. This body takes about 2.5 times that bound: its time goes
// to each stage's shared-memory reads and the per-row barrier, not to the
// copies, which the copying warp overlaps (PERF.md). At ρ = 3 a launch
// holds two stages (kMaxHalo), so a block has two stage warps and a ν = 3
// phase takes two launches: there it is slower than the per-sweep kernel
// (jacobi_sweep.cu) on the same phase (PERF.md).
//
// The design: blocks march along axis 0. A block owns a strip of kW = 128
// loaded columns, hp of them halo on each side, and a segment of rows. It
// streams the segment's rows, with the rows the halo needs above and below,
// through a ring of kR rows in shared memory: per row the 12 operand planes
// (9 coefficients, r, sid, z). The block's last warp only copies: cp.async,
// kPrefetch rows ahead of the row the block consumes, one 16-byte piece per
// lane and plane. Every sweep that reads neighbours, and the residual, is a
// stage: one warp, each lane 4 adjacent columns read and written as float4.
// Stage s works s·(ρ+1) rows behind the row that just arrived, so all it
// reads (the previous stage's z up to ρ rows below its row) was written one
// step before: the stages run side by side with one block barrier per row.
// Each stage keeps its z in a ring of (≥ 2ρ + 3) 8 or 16 rows for the next
// stage and, under Chebyshev, for the stage after that (z_prev is the z two
// stages back, at the node itself). The from-zero step z₁ = c·sid·r (c = 1
// Jacobi, c2_0 Chebyshev; pallas_stencil.py:549-550, 705-711) reads no
// neighbours: the first stage's lanes compute it as each row arrives. The
// last stage writes z, or r − A z from the z the stage before holds in
// shared memory. A stage's values are exact as far as its neighbours were,
// so stage s is exact on the strip's columns hp − (S − s)·ρ .. and its rows
// (S − s)·ρ beyond the segment, and the output is what the last stage
// computes inside the segment. Edges are global: windows and data pairs are
// bounded by the node's grid index (normal_apply.cuh's rules), and an
// interior node, ρ or more from every edge, takes the combined form: one
// coefficient per offset of the ±ρ cross and the 3×3 box (the smoothness
// stencils' autocorrelations added to the data term's coefficients), 13
// products at ρ = 2 where the windowed form takes 27.
//
// Against the tile kernel it replaces (a 64 × 32 tile holding 13 planes in
// shared memory, one thread per node, loaded before the first sweep):
// 1. halo: on axis 1 only, hp = 8 of 128 columns for 3 or 4 stages at ρ = 2
//    (reads 1.14×), and on axis 0 2·S·ρ rows per segment of 586 rows at 4096²
//    (1.02×), where the tile read 1.97× from z and would read 2.67× with the
//    residual;
// 2. shared memory: 12 planes × kR = 16 rows of the strip (97 KB), plus the
//    stages' z rings; each operand is read at the node, by one float4 per
//    lane, and only z around it; two blocks share an SM;
// 3. the next rows load while the current ones are swept, by a warp that
//    does nothing else, so a stage never waits to issue a copy (stages that
//    issued their own copies added the copies' time to the sweeps');
// 4. the residual is the last stage of the same launch, where the cycle ran
//    an apply launch and a subtraction after the smoothing.
// Rows per block are set per launch so that the grid is about one wave of
// resident blocks (two per SM), down to kMinRows rows (with 64, grids of
// about 1000² left most SMs one block).
//
// Lanes (the same kernels under vmap, the batched cycle's smoothing phases):
// B independent phases in the launches of one, the lane from blockIdx.z,
// which the strips (x) and row segments (y) leave free; the ring in shared
// memory stays a block's own. Lane b's arrays (r, z, z_prev, the outputs,
// sid, the nine data planes and the schedule) start b lanes past lane 0's,
// with 64-bit lane offsets and 32-bit node indices within a lane. The
// float4 path needs every lane's rows 16-byte aligned: n1 % 4 == 0 makes a
// lane (n0·n1 floats) and its nine planes whole 16-byte pieces, so the
// host's test on the base pointers and n1 holds for every lane, and a
// ragged batch (1000 × 1030) takes the scalar path for the whole launch.
// The rows per block shrink with B to keep about one wave. The lane offsets
// are a template parameter (kLaneIndex), so one field (B = 1) runs the kernel
// without them: the shifted pointers took its registers from 96 to 124 and
// its 4096² phase ~15% slower (NVIDIA H100 80GB HBM3, 700 W). A lane's
// arithmetic is the single field's, node for node, whatever block computes
// it: its output is the same bits.
#include <algorithm>
#include <cstdint>

#include "normal_apply.cuh"

namespace {

constexpr int kW = 128;         // strip width in loaded columns
constexpr int kCols = 4;        // adjacent columns per thread, read and written as a float4
constexpr int kLanes = kW / kCols;  // threads per stage, whole warps
constexpr int kPad = 4;         // zero columns either side of a z row: reads reach ρ ≤ 3 past the strip
constexpr int kZRow = kW + 2 * kPad;  // floats per z row
constexpr int kPlanes = 12;     // operand planes of the ring: 9 coefficients, r, sid, z
constexpr int kPlaneR = 9, kPlaneSid = 10, kPlaneZ = 11;
constexpr int kPrefetch = 3;    // rows in flight ahead of the row being consumed
constexpr int kMaxHalo = 8;     // neighbour-reading stages × ρ per launch
constexpr int kMinRows = 32;    // fewest output rows a block takes
static_assert(kW == 4 * 32 && kCols == 4, "a row is one 16-byte piece per lane of a warp");

// Rows of a stage's z ring: ≥ 2ρ + 3 (the next stage reads ρ rows either side
// of a row L = ρ + 1 behind; the Chebyshev stage after it the row 2L behind).
template <int kRho>
constexpr int kZRing = kRho <= 2 ? 8 : 16;

// One launch's operands. z null: the launch starts with the from-zero step.
struct Strip {
    const float* r;
    const float* z;
    const float* sid;
    const float* cf;     // the Chebyshev schedule; null: damped Jacobi
    const float* zprev;  // Chebyshev z_prev of the first sweep from z (null: zeros)
    float* out;          // z after the launch's sweeps (null: not written)
    float* res;          // r − A z (null: no residual stage)
    float* zprev_out;    // Chebyshev z_prev after the launch (null: not written)
    ApplyOp op;
    int stages;          // S: the neighbour-reading sweeps, then the residual
    int sweeps;          // the neighbour-reading sweeps among them
    int kr;              // schedule row of the first neighbour-reading sweep
    int hp;              // halo columns on each side of the strip, a multiple of 4
    int seg;             // output rows per block
    int ring;            // kR: rows of the operand ring, a power of two
    int vec;             // 1: every grid row is 16-byte aligned (n1 % 4 == 0)
    int lanes;           // B: lane blockIdx.z's arrays start that many lanes past lane 0's
    int lane_cf;         // floats a lane of the schedule
};

__device__ __forceinline__ unsigned smem_addr(const float* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// Copy `bytes` (the piece's size, or 0: zeros) from global to shared memory.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_prefetch() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kPrefetch - 1) : "memory");
}

// The kCols = 4 floats at p (16-byte aligned), and back, as one vector access.
__device__ __forceinline__ void ldv(const float* p, float (&v)[kCols]) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}
__device__ __forceinline__ void stv(float* p, const float (&v)[kCols]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// v[k] to p[k] in global memory for the columns j + k inside the grid, as one
// vector where rows are aligned.
__device__ __forceinline__ void store_cols(float* p, const float (&v)[kCols], int j, int n1,
                                           bool vec) {
    if (vec && j + kCols <= n1) {
        stv(p, v);
        return;
    }
#pragma unroll
    for (int k = 0; k < kCols; ++k)
        if (j + k >= 0 && j + k < n1) p[k] = v[k];
}

__device__ __forceinline__ const float* operand_plane(const Strip& st, int p) {
    return p < 9 ? st.op.coeff + p * (st.op.n0 * st.op.n1)
                 : p == kPlaneR ? st.r : p == kPlaneSid ? st.sid : st.z;
}

template <int kRho, bool kCheb, bool kLaneIndex>
__global__ void __launch_bounds__(kLanes * (kMaxHalo / kRho) + 32)
multisweep2d_kernel(Strip st) {
    constexpr int L = kRho + 1;  // rows between one stage's row and the next stage's
    constexpr int RZ = kZRing<kRho>;
    // Shared memory: the operand planes 0-10 as [11][kR][kW], the loaded z
    // as [kR][kZRow], then stage q's z ring as [RZ][kZRow], q = 1 .. S − 1.
    extern __shared__ __align__(16) float smem[];
    if constexpr (kLaneIndex) {  // the block's lane: its arrays start blockIdx.z lanes past lane 0's
        const size_t b = blockIdx.z;
        const size_t at = b * static_cast<size_t>(st.op.n0) * st.op.n1;
        st.r += at;
        st.sid += at;
        st.op.coeff += 9 * at;
        if (st.z != nullptr) st.z += at;
        if (st.zprev != nullptr) st.zprev += at;
        if (st.out != nullptr) st.out += at;
        if (st.res != nullptr) st.res += at;
        if (st.zprev_out != nullptr) st.zprev_out += at;
        if (st.cf != nullptr) st.cf += b * st.lane_cf;
    }
    const int R = st.ring, S = st.stages, n0 = st.op.n0, n1 = st.op.n1;
    const int lane = threadIdx.x % kLanes;
    const int s = threadIdx.x / kLanes + 1;  // the thread's stage: one warp each
    const int c = kCols * lane;              // and first column of the strip
    const int cl = blockIdx.x * (kW - 2 * st.hp) - st.hp;  // grid column of strip column 0
    const int j = cl + c;
    const int r0 = blockIdx.y * st.seg, r1 = min(r0 + st.seg, n0);
    const int y0 = r0 - S * kRho;                // grid row of loaded row 0
    const int U = r1 - r0 + 2 * S * kRho;        // rows loaded
    const int T = U + S;                         // steps: the last stage's last row is U − Sρ − 1 + S·L
    const int zplane = kPlaneZ * R * kW;         // the loaded z, rows of kZRow
    const int zrings = zplane + R * kZRow;       // stage 1's z ring
    // Stage s reads z_{s−1} around its nodes and, under Chebyshev, z_{s−2}
    // at them: the loaded z for q = 0, else stage q's ring. Offsets point at
    // column c of row 0.
    auto ring_base = [&](int q) { return (q == 0 ? zplane : zrings + (q - 1) * RZ * kZRow) + kPad + c; };
    auto ring_mask = [&](int q) { return q == 0 ? R - 1 : RZ - 1; };
    const int in_base = ring_base(max(s - 1, 0)), in_mask = ring_mask(max(s - 1, 0));
    const int lo = st.hp - (S - s) * kRho;       // stage s is exact on strip columns [lo, kW − lo)
    const bool cols_stage = c + kCols > lo && c < kW - lo && j + kCols > 0 && j < n1;
    const bool cols_out = c >= st.hp && c < kW - st.hp && j < n1;
    const bool residual_stage = st.res != nullptr && s == S;
    const int k = st.kr + s - 1;                 // schedule row of stage s's sweep
    const float c0 = kCheb && st.z == nullptr ? st.cf[2 * (st.kr - 1) + 1] : 1.f;
    const float c1 = kCheb && s <= st.sweeps ? st.cf[2 * k] : 0.f;
    const float c2 = kCheb && s <= st.sweeps ? st.cf[2 * k + 1] : 1.f;
    // The interior form: Σ_orders w² Σ_axes BᵀB as one weight per offset of
    // the cross (the autocorrelations of the taps: 2/−1; 6/−4/1; 20/−15/6/−1).
    // (Read by value: taking the address of a kernel parameter costs a local copy.)
    const float w2[4] = {st.op.w2[0], st.op.w2[1], st.op.w2[2], st.op.w2[3]};
    const float a0 = w2[0] + 2.f * (2.f * w2[1] + 6.f * w2[2] + 20.f * w2[3]);
    const float a1 = -(w2[1] + 4.f * w2[2] + 15.f * w2[3]);
    const float a2 = w2[2] + 6.f * w2[3];
    const float a3 = -w2[3];

    // The pad columns of every z row are zeros (never written after this).
    for (int i = threadIdx.x; i < (R + max(S - 1, 0) * RZ) * 2 * kPad; i += blockDim.x) {
        const int row = i / (2 * kPad), col = i % (2 * kPad);
        smem[zplane + row * kZRow + (col < kPad ? col : kW + col)] = 0.f;
    }
    // The block's last warp copies the rows: of each plane (the z plane
    // only from z) lane l the 16 bytes at columns 4l .. 4l + 3, or the four
    // columns l + 32i where rows are not 16-byte aligned. The stages never
    // wait to issue copies.
    const int planes = st.z != nullptr ? kPlanes : kPlanes - 1;
    const bool producer = threadIdx.x >= kLanes * max(S, 1);
    const int pl = threadIdx.x % 32;
    auto load_row = [&](int u) {
        const int y = y0 + u;
        if (!producer || y < 0 || y >= n0) return;
        const int slot = u & (R - 1);
        for (int p = 0; p < planes; ++p) {
            const float* src = operand_plane(st, p) + y * n1;
            float* dst = smem + (p == kPlaneZ ? zplane + slot * kZRow + kPad : (p * R + slot) * kW);
            if (st.vec) {
                const int jj = cl + 4 * pl;
                const bool in = jj >= 0 && jj < n1;  // wholly in or out: n1 % 4 == 0
                cp_async16(dst + 4 * pl, in ? src + jj : src, in ? 16 : 0);
            } else {
#pragma unroll
                for (int q = 0; q < kW / 32; ++q) {
                    const int jj = cl + pl + 32 * q;
                    const bool in = jj >= 0 && jj < n1;
                    cp_async4(dst + pl + 32 * q, in ? src + jj : src, in ? 4 : 0);
                }
            }
        }
    };

    for (int p = 0; p < kPrefetch; ++p) {
        if (p < U) load_row(p);
        cp_async_commit();
    }
    for (int t = 0; t < T; ++t) {
        cp_async_wait_prefetch();  // row t has landed ...
        __syncthreads();           // ... for everyone; the slot of row t + kPrefetch is free
        if (t + kPrefetch < U) load_row(t + kPrefetch);
        cp_async_commit();

        if (s == 1 && t < U && y0 + t >= 0 && y0 + t < n0) {
            // Stage 0, row t as it arrives: the from-zero step z₁ = c0·sid·r.
            const int x = y0 + t, slot = t & (R - 1);
            float* zp = smem + in_base + slot * kZRow;  // stage 1 reads the loaded z
            float zv[kCols];
            if (st.z == nullptr) {
                float rv[kCols], sv[kCols];
                ldv(smem + (kPlaneR * R + slot) * kW + c, rv);
                ldv(smem + (kPlaneSid * R + slot) * kW + c, sv);
#pragma unroll
                for (int q = 0; q < kCols; ++q) zv[q] = c0 * (sv[q] * rv[q]);
                stv(zp, zv);
            }
            if (st.sweeps == 0 && st.out != nullptr && cols_out && x >= r0 && x < r1) {
                ldv(zp, zv);
                store_cols(st.out + x * n1 + j, zv, j, n1, st.vec);
                if (kCheb && st.zprev_out != nullptr) {
                    const float zero[kCols] = {};
                    store_cols(st.zprev_out + x * n1 + j, zero, j, n1, st.vec);
                }
            }
        }
        const int u = t - s * L;  // stage s's loaded row
        if (s > S || u < s * kRho || u >= U - s * kRho || !cols_stage) continue;
        const int x = y0 + u;
        if (x < 0 || x >= n0) continue;
        const int slot = u & (R - 1);
        auto row_at = [&](int d) { return smem + in_base + ((u + d) & in_mask) * kZRow; };
        // z_{s−1} around the thread's nodes, in pieces of kCols columns: the
        // row itself ±B pieces (B·kCols ≥ ρ), rows ±1 one piece either side,
        // rows ±2 .. ±ρ at the nodes' columns.
        constexpr int B = (kRho + kCols - 1) / kCols;
        float zm[(2 * B + 1) * kCols], zu[3 * kCols], zl[3 * kCols];
        float zf[2 * (kRho - 1) + 1][kCols];
#pragma unroll
        for (int b = -B; b <= B; ++b) {
            float v[kCols];
            ldv(row_at(0) + b * kCols, v);
#pragma unroll
            for (int q = 0; q < kCols; ++q) zm[(b + B) * kCols + q] = v[q];
        }
#pragma unroll
        for (int b = -1; b <= 1; ++b) {
            float v[kCols];
            ldv(row_at(-1) + b * kCols, v);
#pragma unroll
            for (int q = 0; q < kCols; ++q) zu[(b + 1) * kCols + q] = v[q];
            ldv(row_at(1) + b * kCols, v);
#pragma unroll
            for (int q = 0; q < kCols; ++q) zl[(b + 1) * kCols + q] = v[q];
        }
#pragma unroll
        for (int d = 2; d <= kRho; ++d) {
            ldv(row_at(-d), zf[2 * (d - 2)]);
            ldv(row_at(d), zf[2 * (d - 2) + 1]);
        }
        // X(q, d0, d1): z_{s−1} at (x + d0, j + q + d1); |d1| ≤ ρ on row 0,
        // ≤ 1 on rows ±1, 0 beyond.
        auto X = [&](int q, int d0, int d1) {
            return d0 == 0 ? zm[B * kCols + q + d1]
                 : d0 == -1 ? zu[kCols + q + d1]
                 : d0 == 1 ? zl[kCols + q + d1]
                 : zf[2 * ((d0 < 0 ? -d0 : d0) - 2) + (d0 > 0 ? 1 : 0)][q];
        };
        float cv[9][kCols], rv[kCols], sv[kCols];
#pragma unroll
        for (int ch = 0; ch < 9; ++ch) ldv(smem + (ch * R + slot) * kW + c, cv[ch]);
        ldv(smem + (kPlaneR * R + slot) * kW + c, rv);
        float az[kCols];
        if (x >= kRho && x < n0 - kRho && j >= kRho && j + kCols <= n1 - kRho) {
#pragma unroll
            for (int q = 0; q < kCols; ++q) {
                az[q] = (a0 + cv[4][q]) * X(q, 0, 0) + (a1 + cv[3][q]) * X(q, 0, -1)
                        + (a1 + cv[5][q]) * X(q, 0, 1) + (a1 + cv[1][q]) * X(q, -1, 0)
                        + (a1 + cv[7][q]) * X(q, 1, 0) + cv[0][q] * X(q, -1, -1)
                        + cv[2][q] * X(q, -1, 1) + cv[6][q] * X(q, 1, -1) + cv[8][q] * X(q, 1, 1);
                if constexpr (kRho >= 2)
                    az[q] += a2 * (X(q, 0, -2) + X(q, 0, 2) + X(q, -2, 0) + X(q, 2, 0));
                if constexpr (kRho >= 3)
                    az[q] += a3 * (X(q, 0, -3) + X(q, 0, 3) + X(q, -3, 0) + X(q, 3, 0));
            }
        } else {  // normal_apply.cuh's smooth_at + data_at, windows cut by the grid's edges
#pragma unroll
            for (int q = 0; q < kCols; ++q) {
                const int jq = j + q;
                auto x0 = [&](int d) { return X(q, d, 0); };
                auto x1 = [&](int d) { return X(q, 0, d); };
                float sm = w2[0] != 0.f ? w2[0] * X(q, 0, 0) : 0.f;
                if (w2[1] != 0.f)
                    sm += w2[1] * (axis_normal<2>(x0, x, n0) + axis_normal<2>(x1, jq, n1));
                if constexpr (kRho >= 2)
                    if (w2[2] != 0.f)
                        sm += w2[2] * (axis_normal<3>(x0, x, n0) + axis_normal<3>(x1, jq, n1));
                if constexpr (kRho >= 3)
                    if (w2[3] != 0.f)
                        sm += w2[3] * (axis_normal<4>(x0, x, n0) + axis_normal<4>(x1, jq, n1));
                float data = 0.f;
#pragma unroll
                for (int ch = 0; ch < 9; ++ch) {
                    const int d0 = ch / 3 - 1, d1 = ch % 3 - 1;
                    if (x + d0 < 0 || x + d0 >= n0 || jq + d1 < 0 || jq + d1 >= n1) continue;
                    data += cv[ch][q] * X(q, d0, d1);
                }
                az[q] = sm + data;
            }
        }
        const bool out_rows = cols_out && x >= r0 && x < r1;
        float zn[kCols];
        if (residual_stage) {
            if (!out_rows) continue;
#pragma unroll
            for (int q = 0; q < kCols; ++q) zn[q] = rv[q] - az[q];
            store_cols(st.res + x * n1 + j, zn, j, n1, st.vec);
            continue;
        }
        ldv(smem + (kPlaneSid * R + slot) * kW + c, sv);
        float zp[kCols];
        if (kCheb) {
            // Stage 1's z_prev: zeros after the from-zero step; from z the
            // launch's z_prev, which is z itself where the phase starts.
            if (s >= 2) {
                ldv(smem + ring_base(s - 2) + (u & ring_mask(s - 2)) * kZRow, zp);
            } else {
#pragma unroll
                for (int q = 0; q < kCols; ++q)
                    zp[q] = st.z == nullptr || st.zprev == nullptr ? 0.f
                            : st.zprev == st.z ? X(q, 0, 0)
                            : j + q >= 0 && j + q < n1 ? st.zprev[x * n1 + j + q] : 0.f;
            }
        }
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
            const float zc = X(q, 0, 0);
            zn[q] = kCheb ? zc + (c1 * (zc - zp[q]) + c2 * (sv[q] * (rv[q] - az[q])))
                          : zc + sv[q] * (rv[q] - az[q]);
        }
        if (s < S) stv(smem + zrings + (s - 1) * RZ * kZRow + (u & (RZ - 1)) * kZRow + kPad + c, zn);
        if (s == st.sweeps && st.out != nullptr && out_rows) {
            store_cols(st.out + x * n1 + j, zn, j, n1, st.vec);
            if (kCheb && st.zprev_out != nullptr) {
                float zc[kCols];
#pragma unroll
                for (int q = 0; q < kCols; ++q) zc[q] = X(q, 0, 0);
                store_cols(st.zprev_out + x * n1 + j, zc, j, n1, st.vec);
            }
        }
    }
}

template <int kRho, bool kCheb, bool kLaneIndex>
cudaError_t launch_strips(Strip st, cudaStream_t stream) {
    const int S = st.stages, L = kRho + 1;
    // The ring holds a row from its copy, kPrefetch steps ahead, to its last
    // read, S·L steps after it arrived (the first stage's reads of the z
    // plane reach 2ρ + 1 back).
    const int depth = S == 0 ? 0 : std::max(S * L, 2 * kRho + 1);
    st.ring = 4;
    while (st.ring < depth + kPrefetch + 1) st.ring *= 2;
    const size_t smem = (static_cast<size_t>(kPlanes - 1) * st.ring * kW
                         + (static_cast<size_t>(st.ring)
                            + static_cast<size_t>(std::max(S - 1, 0)) * kZRing<kRho>) * kZRow)
                        * sizeof(float);
    const int threads = kLanes * std::max(S, 1) + 32;  // the stages and the copying warp
    auto kernel = multisweep2d_kernel<kRho, kCheb, kLaneIndex>;
    // Above 48 KB of shared memory a block needs the opt-in (per device, so
    // set at every launch; it costs no device work).
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int per_sm = 0, dev = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    const int n0 = st.op.n0, n1 = st.op.n1;
    st.hp = (S * kRho + 3) & ~3;
    const int strips = (n1 + kW - 2 * st.hp - 1) / (kW - 2 * st.hp);
    // About one wave of resident blocks over all lanes; a refused launch
    // (per_sm = 0) fails below.
    const int segs = std::max(1, std::min((n0 + kMinRows - 1) / kMinRows,
                                          per_sm * sms / (strips * st.lanes)));
    st.seg = (n0 + segs - 1) / segs;
    const dim3 grid(strips, (n0 + st.seg - 1) / st.seg, st.lanes);
    kernel<<<grid, threads, smem, stream>>>(st);
    return cudaGetLastError();
}

template <bool kLaneIndex>
cudaError_t launch_strips(const Strip& st, int rho, cudaStream_t stream) {
    const bool cheb = st.cf != nullptr;
    switch (rho) {
        case 1: return cheb ? launch_strips<1, true, kLaneIndex>(st, stream)
                            : launch_strips<1, false, kLaneIndex>(st, stream);
        case 2: return cheb ? launch_strips<2, true, kLaneIndex>(st, stream)
                            : launch_strips<2, false, kLaneIndex>(st, stream);
        default: return cheb ? launch_strips<3, true, kLaneIndex>(st, stream)
                             : launch_strips<3, false, kLaneIndex>(st, stream);
    }
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

}  // namespace

// The halo, in nodes, one launch reads on each side (neighbour-reading
// stages × ρ); the wrapper reads it to know when a phase takes more than
// one launch.
extern "C" int fi_multisweep2d_max_halo() { return kMaxHalo; }

// One smoothing phase of `count` sweeps on an n0 × n1 grid with the [9, n0,
// n1] data stencil, and then, where res is not null, res = r − A z_out; on B
// lanes (≤ 65,535, gridDim.z), every array [B, ...] contiguous (one field is
// B = 1). cf null: damped Jacobi; else the [ν, 2] Chebyshev schedule on the
// device, cf_lane floats a lane.
// from_zero: the first of the `count` sweeps is the from-zero step (z is not
// read; count ≥ 1); else the sweeps start from z with z_prev = z. The
// phase's z lands in zout (not written when count == 0 from z). A launch
// takes as many neighbour-reading stages (sweeps, then the residual) as keep
// stages·ρ within kMaxHalo, ρ = rho; a longer phase is several launches that
// hand on z through zout and tmp (needed when it takes two or more) and,
// under Chebyshev, z_prev through prev_a and prev_b. *launches: the kernel
// launches enqueued on `stream`. Returns a cudaError_t.
extern "C" int fi_multisweep2d_phase(const float* r, const float* z, const float* coeff,
                                     const float* sid, float* zout, float* tmp, float* prev_a,
                                     float* prev_b, float* res, int B, int n0, int n1,
                                     float w2_0, float w2_1, float w2_2, float w2_3, int rho,
                                     const float* cf, int cf_lane, int count, int from_zero,
                                     int* launches, void* stream) {
    *launches = 0;
    const int reading = count - (from_zero ? 1 : 0);  // sweeps that read neighbours
    if (rho < 1 || rho > 3 || reading < 0 || n0 < 1 || n1 < 1 || B < 1 || B > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    if (!from_zero && count == 0 && res == nullptr) return static_cast<int>(cudaSuccess);
    const int per = kMaxHalo / rho;
    const ApplyOp op{coeff, n0, n1, 0, {w2_0, w2_1, w2_2, w2_3}, 1};
    const bool vec = n1 % 4 == 0 && aligned16(r) && aligned16(sid) && aligned16(coeff);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    // Walk the launches; with `run` false only count those that sweep, whose
    // outputs alternate between zout and tmp so that the last lands in zout.
    auto walk = [&](bool run, int sweeping) -> int {
        int need = reading + (res != nullptr ? 1 : 0), row = 0, i = 0, pi = 0;
        const float* src = from_zero ? nullptr : z;
        const float* prev = src;
        do {
            const int stages = std::min(need, per);
            const bool last = stages == need;
            const int sweeps = stages - (last && res != nullptr ? 1 : 0);
            const int k = sweeps + (src == nullptr ? 1 : 0);  // the from-zero step included
            float* dst = k > 0 ? ((sweeping - 1 - i++) % 2 == 0 ? zout : tmp) : nullptr;
            const int after = need - stages;
            float* pout = cf != nullptr && after > (res != nullptr ? 1 : 0)
                              ? (pi++ % 2 == 0 ? prev_a : prev_b) : nullptr;
            if (run) {
                const bool missing = (k > 0 && dst == nullptr)
                                     || (cf != nullptr && after > (res != nullptr ? 1 : 0)
                                         && pout == nullptr);
                if (missing) return -static_cast<int>(cudaErrorInvalidValue);
                Strip st{r, src, sid, cf, prev, dst, last ? res : nullptr, pout, op,
                         stages, sweeps, row + (src == nullptr ? 1 : 0), 0, 0, 0,
                         vec && aligned16(src) && aligned16(prev) && aligned16(dst)
                                 && aligned16(res) && aligned16(pout) ? 1 : 0,
                         B, cf_lane};
                const cudaError_t err = B > 1 ? launch_strips<true>(st, rho, s)
                                              : launch_strips<false>(st, rho, s);
                if (err != cudaSuccess) return -static_cast<int>(err);
                ++*launches;
            }
            need = after;
            row += k;
            if (dst != nullptr) src = dst;
            prev = pout;
        } while (need > 0);
        return i;
    };
    const int rc = walk(true, walk(false, 0));
    return rc < 0 ? -rc : static_cast<int>(cudaSuccess);
}
