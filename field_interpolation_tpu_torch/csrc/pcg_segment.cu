// fused_pcg_solve for Hopper: one safeguarded CG segment with a symmetric
// damped-Jacobi multigrid V-cycle preconditioner, in ONE persistent
// cooperative kernel per segment.
//
// Replaces field_interpolation_tpu/ops/pallas_stencil.py:fused_pcg_solve
// (lines 1484-1629) with _vcycle_refs (1439-1481), _smooth_inplace
// (1016-1027) and the coarse solve (1426-1436).
//
//   z = V(r); p = z
//   while rr > tol2 and k < budget:
//       Ap = A p;  α = rz/⟨p,Ap⟩ (0 if ⟨p,Ap⟩ ≤ 0)
//       x += αp;  r −= αAp;  rr = ⟨r,r⟩
//       z = V(r);  β = ⟨r,z⟩/rz (0 if rz ≤ 0);  p = z + βp
//
// What bounds it on the H100: grid-wide synchronisation. A V-cycle over
// five levels is a chain of ~40 dependent stencil phases, most of them on
// coarse levels with a few hundred to a few thousand nodes; their work is
// tiny and each phase boundary is a grid barrier (40 per CG iteration at
// 256² with ν = 3). The 256² working set (9 coefficient planes + 9 field
// arrays + the coarser levels, ~6 MB) sits in the 50 MB L2, so HBM is not
// the limit.
// What the design does about it: the whole segment is one launch (no host
// round trip per iteration, as the TPU kernel's in-kernel while loop); the
// loop decision is made from block partials summed in a fixed order by every
// block, so every block takes the same exit and the iteration count is
// deterministic (no float atomics); Jacobi sweeps ping-pong two buffers so
// each sweep is one phase; the transfers read the dense R only over its
// band (≤ 4 entries per row) from host-built band tables. Fewer barriers
// (fused phases, one block per coarse level) are later work.
#include <cooperative_groups.h>

#include <cstdint>

#include "normal_apply.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;  // power of two: block_sum's tree needs it
enum Slot { kPAp = 0, kRR = 1, kRZ = 2, kSlots = 3 };

struct Level {
    ApplyOp op;         // this level's operator (level 0: full 9-channel data)
    const float* sid;   // τ_l · D_l⁻¹
    float* r;           // residual (level 0: the working CG residual)
    float* za;          // ping-pong correction buffers
    float* zb;
    float* az;          // A z scratch (level 0: also A p)
};

struct Transfer {       // level l (fine, nf0×nf1) ↔ level l+1 (coarse, nc0×nc1)
    const float* R0;    // [nc0, nf0] = _resize_matrix(nf0, nc0).T
    const float* R1;    // [nc1, nf1]
    const int* rb0;     // [nc0, 2] per coarse index: first fine index, span
    const int* rb1;     // [nc1, 2]
    const int* pb0;     // [nf0, 2] per fine index: first coarse index, span
    const int* pb1;     // [nf1, 2]
};

struct Params {
    int L, nu, capacity;
    Level lv[kMaxLevels];
    Transfer tr[kMaxLevels - 1];
    const float* inv;   // [Nc, Nc] dense inverse of the coarsest operator
    const float* x_in;
    const float* r_in;
    const float* tol2;  // (1,1)
    const int* budget;  // (1,1)
    float* x;           // out
    float* p;           // search direction
    int* iters_out;     // (1,1)
    float* rr_out;      // (1,1)
    float* partials;    // [kSlots, capacity] per-block dot partials
};

__device__ __forceinline__ int gtid() { return blockIdx.x * blockDim.x + threadIdx.x; }
__device__ __forceinline__ int gstride() { return gridDim.x * blockDim.x; }
__host__ __device__ __forceinline__ int nodes(const Level& lv) { return lv.op.n0 * lv.op.n1; }

// Fixed-order tree sum over the block; every thread gets the result.
__device__ float block_sum(float v, float* sh) {
    sh[threadIdx.x] = v;
    __syncthreads();
    for (int s = kThreads / 2; s > 0; s >>= 1) {
        if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
        __syncthreads();
    }
    const float r = sh[0];
    __syncthreads();
    return r;
}

__device__ void write_partial(const Params& p, int slot, float v, float* sh) {
    const float s = block_sum(v, sh);
    if (threadIdx.x == 0) p.partials[slot * p.capacity + blockIdx.x] = s;
}

// After a grid barrier: every block sums all partials in the same order, so
// all blocks hold the same bits and take the same branch.
__device__ float grid_total(const Params& p, int slot, float* sh) {
    float v = 0.f;
    for (int i = threadIdx.x; i < gridDim.x; i += kThreads)
        v += p.partials[slot * p.capacity + i];
    return block_sum(v, sh);
}

// z_out = z_in + sid·(r − A z_in); z_in == nullptr means z_in = 0, so the
// first sweep from zero is z_out = sid·r (pallas_stencil.py:1019-1024).
// Returns this thread's share of Σ r·z_out when want_dot.
__device__ float sweep(const Level& lv, const float* zin, float* zout, bool want_dot) {
    const int N = nodes(lv), n1 = lv.op.n1;
    float acc = 0.f;
    for (int i = gtid(); i < N; i += gstride()) {
        const float r = lv.r[i];
        const float z = zin ? zin[i] + lv.sid[i] * (r - apply_at(lv.op, zin, i / n1, i % n1))
                            : lv.sid[i] * r;
        zout[i] = z;
        if (want_dot) acc += r * z;
    }
    return acc;
}

__device__ void fill_zero(const Level& lv, float* z) {
    for (int i = gtid(); i < nodes(lv); i += gstride()) z[i] = 0.f;
}

__device__ void apply_phase(const Level& lv, const float* z, float* az) {
    const int N = nodes(lv), n1 = lv.op.n1;
    for (int i = gtid(); i < N; i += gstride()) az[i] = apply_at(lv.op, z, i / n1, i % n1);
}

// r_c = R0 · (r_f − A z_f) · R1ᵀ over the bands of R0 and R1.
__device__ void restrict_phase(const Params& p, int l) {
    const Level& f = p.lv[l];
    const Level& c = p.lv[l + 1];
    const Transfer& t = p.tr[l];
    const int nf0 = f.op.n0, nf1 = f.op.n1, nc1 = c.op.n1;
    for (int jj = gtid(); jj < nodes(c); jj += gstride()) {
        const int j0 = jj / nc1, j1 = jj % nc1;
        const int s0 = t.rb0[2 * j0], c0 = t.rb0[2 * j0 + 1];
        const int s1 = t.rb1[2 * j1], c1 = t.rb1[2 * j1 + 1];
        float acc = 0.f;
        for (int a = 0; a < c0; ++a) {
            const int i0 = s0 + a;
            float row = 0.f;
            for (int b = 0; b < c1; ++b) {
                const int i = i0 * nf1 + s1 + b;
                row += t.R1[j1 * nf1 + s1 + b] * (f.r[i] - f.az[i]);
            }
            acc += t.R0[j0 * nf0 + i0] * row;
        }
        c.r[jj] = acc;
    }
}

// z_f += R0ᵀ · z_c · R1 over the bands; returns Σ r·z_f when want_dot.
__device__ float prolong_phase(const Params& p, int l, const float* zc, float* zf,
                               bool want_dot) {
    const Level& f = p.lv[l];
    const Transfer& t = p.tr[l];
    const int nf0 = f.op.n0, nf1 = f.op.n1, nc1 = p.lv[l + 1].op.n1;
    float dot = 0.f;
    for (int ii = gtid(); ii < nodes(f); ii += gstride()) {
        const int i0 = ii / nf1, i1 = ii % nf1;
        const int s0 = t.pb0[2 * i0], c0 = t.pb0[2 * i0 + 1];
        const int s1 = t.pb1[2 * i1], c1 = t.pb1[2 * i1 + 1];
        float acc = 0.f;
        for (int a = 0; a < c0; ++a) {
            const int j0 = s0 + a;
            float row = 0.f;
            for (int b = 0; b < c1; ++b) {
                const int j1 = s1 + b;
                row += t.R1[j1 * nf1 + i1] * zc[j0 * nc1 + j1];
            }
            acc += t.R0[j0 * nf0 + i0] * row;
        }
        const float z = zf[ii] + acc;
        zf[ii] = z;
        if (want_dot) dot += f.r[ii] * z;
    }
    return dot;
}

// z_c = inv · r_c, one warp per row, lanes striding the columns.
__device__ void coarse_phase(const Params& p) {
    const Level& c = p.lv[p.L - 1];
    const int Nc = nodes(c);
    const int lane = threadIdx.x & 31;
    for (int row = gtid() >> 5; row < Nc; row += gstride() >> 5) {
        float acc = 0.f;
        for (int k = lane; k < Nc; k += 32) acc += p.inv[row * Nc + k] * c.r[k];
        for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (lane == 0) c.za[row] = acc;
    }
}

// One symmetric V-cycle on lv[0].r; returns the buffer holding z_0 and
// leaves Σ r·z_0 in the kRZ partials. Every branch below depends only on
// L, nu and the level index, so all blocks reach the same barriers.
__device__ const float* vcycle(const Params& p, cg::grid_group& g, float* sh) {
    const int L = p.L, nu = p.nu;
    float* z[kMaxLevels];
    for (int l = 0; l < L - 1; ++l) {                     // down: pre-smooth, restrict
        const Level& lv = p.lv[l];
        float* cur = nullptr;
        float* nxt = lv.za;
        if (nu == 0) {
            fill_zero(lv, lv.za);
            cur = lv.za;
            g.sync();
        }
        for (int s = 0; s < nu; ++s) {
            sweep(lv, cur, nxt, false);
            g.sync();
            cur = nxt;
            nxt = (nxt == lv.za) ? lv.zb : lv.za;
        }
        z[l] = cur;
        apply_phase(lv, cur, lv.az);
        g.sync();
        restrict_phase(p, l);
        g.sync();
    }
    coarse_phase(p);                                      // coarsest: dense solve
    g.sync();
    z[L - 1] = p.lv[L - 1].za;
    for (int l = L - 2; l >= 0; --l) {                    // up: prolong-add, post-smooth
        const Level& lv = p.lv[l];
        float* cur = z[l];
        const bool last_prolong = (l == 0 && nu == 0);
        const float d = prolong_phase(p, l, z[l + 1], cur, last_prolong);
        if (last_prolong) write_partial(p, kRZ, d, sh);
        g.sync();
        float* nxt = (cur == lv.za) ? lv.zb : lv.za;
        for (int s = 0; s < nu; ++s) {
            const bool want = (l == 0 && s == nu - 1);
            const float ds = sweep(lv, cur, nxt, want);
            if (want) write_partial(p, kRZ, ds, sh);
            g.sync();
            float* tmp = cur;
            cur = nxt;
            nxt = tmp;
        }
        z[l] = cur;
    }
    return z[0];
}

__global__ void __launch_bounds__(kThreads)
pcg_segment_kernel(const __grid_constant__ Params p) {
    cg::grid_group g = cg::this_grid();
    __shared__ float sh[kThreads];
    const Level& l0 = p.lv[0];
    const int N = nodes(l0), n1 = l0.op.n1;
    const float tol2 = *p.tol2;
    const int budget = *p.budget;

    float acc = 0.f;
    for (int i = gtid(); i < N; i += gstride()) {
        p.x[i] = p.x_in[i];
        const float r = p.r_in[i];
        l0.r[i] = r;
        acc += r * r;
    }
    write_partial(p, kRR, acc, sh);
    g.sync();
    float rr = grid_total(p, kRR, sh);
    const float* z0 = vcycle(p, g, sh);
    float rz = grid_total(p, kRZ, sh);
    for (int i = gtid(); i < N; i += gstride()) p.p[i] = z0[i];
    g.sync();

    int k = 0;
    while (rr > tol2 && k < budget) {
        acc = 0.f;
        for (int i = gtid(); i < N; i += gstride()) {
            const float ap = apply_at(l0.op, p.p, i / n1, i % n1);
            l0.az[i] = ap;
            acc += p.p[i] * ap;
        }
        write_partial(p, kPAp, acc, sh);
        g.sync();
        const float pap = grid_total(p, kPAp, sh);
        const float alpha = pap > 0.f ? rz / pap : 0.f;
        acc = 0.f;
        for (int i = gtid(); i < N; i += gstride()) {
            p.x[i] += alpha * p.p[i];
            const float r = l0.r[i] - alpha * l0.az[i];
            l0.r[i] = r;
            acc += r * r;
        }
        write_partial(p, kRR, acc, sh);
        g.sync();
        const float rr_new = grid_total(p, kRR, sh);
        z0 = vcycle(p, g, sh);
        const float rz_new = grid_total(p, kRZ, sh);
        const float beta = rz > 0.f ? rz_new / rz : 0.f;
        for (int i = gtid(); i < N; i += gstride()) p.p[i] = z0[i] + beta * p.p[i];
        g.sync();
        ++k;
        rz = rz_new;
        rr = rr_new;
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) {
        *p.iters_out = k;
        *p.rr_out = rr;
    }
}

template <typename T>
T* as_ptr(long long v) { return reinterpret_cast<T*>(static_cast<uintptr_t>(v)); }

}  // namespace

// Host tables, filled by field_interpolation_tpu_torch/ops/pcg.py:
//   ptrs: x_in, r_in, tol2, budget, x_out, iters_out, rr_out, rw, p,
//         partials, inv; then 6 per level (coeff, sid, r, za, zb, az; r of
//         level 0 is unused: it is rw); then 6 per transfer (R0, R1, rb0,
//         rb1, pb0, pb1).
//   ints: L, nu, capacity; then 3 per level (n0, n1, diag).
//   w2s:  4 per level (w_k² for orders 0..3).
extern "C" int fi_pcg_segment(const long long* ptrs, const int* ints,
                              const float* w2s, void* stream) {
    Params p{};
    p.L = ints[0];
    p.nu = ints[1];
    p.capacity = ints[2];
    if (p.L < 2 || p.L > kMaxLevels || p.nu < 0 || p.capacity < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    p.x_in = as_ptr<const float>(ptrs[0]);
    p.r_in = as_ptr<const float>(ptrs[1]);
    p.tol2 = as_ptr<const float>(ptrs[2]);
    p.budget = as_ptr<const int>(ptrs[3]);
    p.x = as_ptr<float>(ptrs[4]);
    p.iters_out = as_ptr<int>(ptrs[5]);
    p.rr_out = as_ptr<float>(ptrs[6]);
    float* rw = as_ptr<float>(ptrs[7]);
    p.p = as_ptr<float>(ptrs[8]);
    p.partials = as_ptr<float>(ptrs[9]);
    p.inv = as_ptr<const float>(ptrs[10]);
    for (int l = 0; l < p.L; ++l) {
        const long long* q = ptrs + 11 + 6 * l;
        Level& lv = p.lv[l];
        lv.op.coeff = as_ptr<const float>(q[0]);
        lv.sid = as_ptr<const float>(q[1]);
        lv.r = l == 0 ? rw : as_ptr<float>(q[2]);
        lv.za = as_ptr<float>(q[3]);
        lv.zb = as_ptr<float>(q[4]);
        lv.az = as_ptr<float>(q[5]);
        lv.op.n0 = ints[3 + 3 * l];
        lv.op.n1 = ints[4 + 3 * l];
        lv.op.diag = ints[5 + 3 * l];
        for (int o = 0; o < 4; ++o) lv.op.w2[o] = w2s[4 * l + o];
    }
    for (int t = 0; t < p.L - 1; ++t) {
        const long long* q = ptrs + 11 + 6 * p.L + 6 * t;
        Transfer& tr = p.tr[t];
        tr.R0 = as_ptr<const float>(q[0]);
        tr.R1 = as_ptr<const float>(q[1]);
        tr.rb0 = as_ptr<const int>(q[2]);
        tr.rb1 = as_ptr<const int>(q[3]);
        tr.pb0 = as_ptr<const int>(q[4]);
        tr.pb1 = as_ptr<const int>(q[5]);
    }

    // A cooperative launch needs every block resident at once: size the grid
    // from the occupancy of this kernel, never above it.
    int dev = 0, coop = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pcg_segment_kernel, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (!coop) return static_cast<int>(cudaErrorNotSupported);
    if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    const int want = (nodes(p.lv[0]) + kThreads - 1) / kThreads;
    int blocks = per_sm * sms;
    if (blocks > want) blocks = want;
    if (blocks > p.capacity) blocks = p.capacity;
    void* args[] = {&p};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(pcg_segment_kernel), dim3(blocks),
                                      dim3(kThreads), args, 0,
                                      static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}
