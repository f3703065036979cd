// fused_pcg_solve for Hopper: one safeguarded CG segment with a symmetric
// multigrid V- or W-cycle preconditioner (damped-Jacobi or Chebyshev
// smoothing, lumped or Galerkin coarse levels), in ONE persistent
// cooperative kernel per segment.
//
// Replaces field_interpolation_tpu/ops/pallas_stencil.py:fused_pcg_solve
// (lines 1484-1629) with _vcycle_refs (1439-1481), _smooth_inplace
// (1016-1027) or _cheb_inplace (483-507) and the coarse solve (1426-1436);
// the cycle is
// mg_cycle2d.cuh's, shared with the whole-cycle kernel (mg_cycle2d.cu).
//
//   z = M(r); p = z
//   while rr > tol2 and k < budget:
//       Ap = A p;  α = rz/⟨p,Ap⟩ (0 if ⟨p,Ap⟩ ≤ 0)
//       x += αp;  r −= αAp;  rr = ⟨r,r⟩
//       z = M(r);  β = ⟨r,z⟩/rz (0 if rz ≤ 0);  p = z + βp
//
// What bounds it on the H100: grid-wide synchronisation. A V-cycle over
// five levels is a chain of ~40 dependent stencil phases, most of them on
// coarse levels with a few hundred to a few thousand nodes; their work is
// tiny and each phase boundary is a grid barrier (40 per CG iteration at
// 256² with ν = 3; a W-cycle ~4× as many). The 256² working set (9
// coefficient planes + 9 field arrays + the coarser levels, ~6 MB) sits in
// the 50 MB L2, so HBM is not the limit.
// What the design does about it: the whole segment is one launch (no host
// round trip per iteration, as the TPU kernel's in-kernel while loop); the
// loop decision is made from block partials summed in a fixed order by every
// block, so every block takes the same exit and the iteration count is
// deterministic (no float atomics); Jacobi sweeps ping-pong two buffers so
// each sweep is one phase; the transfers read the dense R only over its
// band (≤ 4 entries per row) from host-built band tables. Fewer grid
// barriers through a coarse tail on one thread-block cluster and merged
// phases (25 an iteration instead of 40) measured slower on the H100
// (PERF.md §6): a cluster phase costs about what a grid phase does, and the
// larger kernel holds two blocks per SM instead of three.
#include "mg_cycle2d.cuh"

namespace {

using namespace mg2d;

enum Slot { kPAp = 0, kRR = 1, kRZ = 2, kSlots = 3 };

struct Params {
    Cycle cyc;          // lv[0].r is the working CG residual
    int capacity;
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

__device__ float* slot(const Params& p, int s) { return p.partials + s * p.capacity; }

// After a grid barrier: every block sums all partials in the same order, so
// all blocks hold the same bits and take the same branch.
__device__ float grid_total(const Params& p, int s, float* sh) {
    float v = 0.f;
    for (int i = threadIdx.x; i < gridDim.x; i += kThreads) v += slot(p, s)[i];
    return block_sum(v, sh);
}

// One call site of the inlined cycle (the start's cycle is the loop's
// first pass) and at least 3 resident blocks per SM keep the kernel at 80
// registers with no spills (two call sites took 128).
__global__ void __launch_bounds__(kThreads, 3)
pcg_segment_kernel(const __grid_constant__ Params p) {
    cg::grid_group g = cg::this_grid();
    __shared__ float sh[kThreads];
    const Level& l0 = p.cyc.lv[0];
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
    write_partial(slot(p, kRR), acc, sh);
    g.sync();
    float rr = grid_total(p, kRR, sh);
    float rz = 0.f;
    int k = -1;  // the first cycle starts the search direction: p = z
    for (;;) {
        const float* z0 = cycle(p.cyc, g, sh, slot(p, kRZ));
        const float rz_new = grid_total(p, kRZ, sh);
        const float beta = (k >= 0 && rz > 0.f) ? rz_new / rz : 0.f;
        for (int i = gtid(); i < N; i += gstride())
            p.p[i] = k >= 0 ? z0[i] + beta * p.p[i] : z0[i];
        g.sync();
        ++k;
        rz = rz_new;
        if (!(rr > tol2 && k < budget)) break;
        acc = 0.f;
        for (int i = gtid(); i < N; i += gstride()) {
            const float ap = apply_at(l0.op, p.p, i / n1, i % n1);
            l0.az[i] = ap;
            acc += p.p[i] * ap;
        }
        write_partial(slot(p, kPAp), acc, sh);
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
        write_partial(slot(p, kRR), acc, sh);
        g.sync();
        rr = grid_total(p, kRR, sh);
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) {
        *p.iters_out = k;
        *p.rr_out = rr;
    }
}

}  // namespace

// Host tables, filled by field_interpolation_tpu_torch/ops/pcg.py:
//   ptrs: x_in, r_in, tol2, budget, x_out, iters_out, rr_out, rw, p,
//         partials, inv; then the cycle's level, transfer and schedule
//         pointers (mg_cycle2d.cuh:fill_cycle; level 0's r entry is 0: it
//         is rw).
//   ints: capacity, then the cycle's ints (L, nu_pre, nu_post, wdepth, then
//         n0, n1, diag per level).
//   w2s:  4 per level (w_k² for orders 0..3).
extern "C" int fi_pcg_segment(const long long* ptrs, const int* ints,
                              const float* w2s, void* stream) {
    Params p{};
    p.capacity = ints[0];
    if (p.capacity < 1 || !fill_cycle(p.cyc, ptrs + 11, ints + 1, w2s,
                                      as_ptr<const float>(ptrs[10])))
        return static_cast<int>(cudaErrorInvalidValue);
    p.x_in = as_ptr<const float>(ptrs[0]);
    p.r_in = as_ptr<const float>(ptrs[1]);
    p.tol2 = as_ptr<const float>(ptrs[2]);
    p.budget = as_ptr<const int>(ptrs[3]);
    p.x = as_ptr<float>(ptrs[4]);
    p.iters_out = as_ptr<int>(ptrs[5]);
    p.rr_out = as_ptr<float>(ptrs[6]);
    p.cyc.lv[0].r = as_ptr<float>(ptrs[7]);
    p.p = as_ptr<float>(ptrs[8]);
    p.partials = as_ptr<float>(ptrs[9]);
    void* args[] = {&p};
    const int want = (nodes(p.cyc.lv[0]) + kThreads - 1) / kThreads;
    return static_cast<int>(launch_cooperative(reinterpret_cast<const void*>(pcg_segment_kernel),
                                               args, want, p.capacity, stream));
}
