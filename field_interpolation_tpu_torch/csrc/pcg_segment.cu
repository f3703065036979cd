// fused_pcg_solve for Hopper: one safeguarded CG segment with a symmetric
// multigrid V- or W-cycle preconditioner (damped-Jacobi or Chebyshev
// smoothing, lumped or Galerkin coarse levels), in ONE persistent
// cooperative kernel per segment; and its batched form (fused_pcg_solve
// under vmap), B independent segments in ONE ordinary launch, one block
// per lane.
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
//
// The batched form (pcg_segment_batch_kernel, BASELINE config 3: 1024 fields
// of 128²): a lane of 16,384 nodes does not need the grid, and a grid
// barrier costs ~2.5 µs where a block barrier costs well under one. So each
// lane is one block of an ordinary launch (blockIdx.x is the lane), the
// phases end in __syncthreads, and the cycle and the CG loop are the same
// code as the single-field kernel's, run under BlockSync (mg_cycle2d.cuh).
// Each block builds its lane's Params in shared memory from the batch's
// base pointers and 64-bit lane offsets (4096 lanes of 128² hold 2.4 GB of
// coefficient planes); the transfer bands and level weights are shared. A
// lane does only its own iterations and leaves the card when it stops; a
// lane with nothing to do (budget 0, or already ‖r‖² ≤ tol2) exits before
// its first cycle. What bounds it: each block's own latency, not HBM's
// rate. ~400 lanes are resident (3 blocks per SM); with every lane doing
// the same iterations, a batch of 128² lanes takes the same time at 8
// lanes as at 1, 2x that from 66 to 396 lanes (the lanes' ~1.3 MB working
// sets no longer fit the 50 MB L2), and steps at each further wave of ~400
// (batch_probe.py --scaling on the H100). A lane's ~40 barrier-separated
// phases each walk its level with 256 threads, 64 nodes a thread on the
// fine level, so a lane costs time in proportion to its nodes: a batch of
// few large lanes is slower than one single-field launch per lane, and
// batch.solve_route sends it there.
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

// The segment, run by every thread of the grid (GridSync) or of one block
// (BlockSync). Loop decisions come from `total`, which every block computes
// the same way, so all take the same exit.
template <class S>
__device__ __forceinline__ void segment(const Params& p, S& s, float* sh) {
    const Level& l0 = p.cyc.lv[0];
    const int N = nodes(l0), n1 = l0.op.n1;
    const float tol2 = *p.tol2;
    const int budget = *p.budget;

    float acc = 0.f;
    for (int i = s.tid(); i < N; i += s.stride()) {
        p.x[i] = p.x_in[i];
        const float r = p.r_in[i];
        l0.r[i] = r;
        acc += r * r;
    }
    write_partial(s, slot(p, kRR), acc, sh);
    s.sync();
    float rr = total(s, slot(p, kRR), sh);
    float rz = 0.f;
    // k counts the CG updates; the first cycle starts the search direction
    // (p = z). The exit test comes before the cycle that would start the
    // next update, so a segment runs no cycle it does not use: none at all
    // when there is nothing to do (budget 0, or ‖r‖² ≤ tol2 already).
    int k = 0;
    for (;; ++k) {
        if (!(rr > tol2 && k < budget)) break;
        const float* z0 = cycle(s, p.cyc, sh, slot(p, kRZ));
        const float rz_new = total(s, slot(p, kRZ), sh);
        const float beta = (k > 0 && rz > 0.f) ? rz_new / rz : 0.f;
        for (int i = s.tid(); i < N; i += s.stride())
            p.p[i] = k > 0 ? z0[i] + beta * p.p[i] : z0[i];
        s.sync();
        rz = rz_new;
        acc = 0.f;
        for (int i = s.tid(); i < N; i += s.stride()) {
            const float ap = apply_at(l0.op, p.p, i / n1, i % n1);
            l0.az[i] = ap;
            acc += p.p[i] * ap;
        }
        write_partial(s, slot(p, kPAp), acc, sh);
        s.sync();
        const float pap = total(s, slot(p, kPAp), sh);
        const float alpha = pap > 0.f ? rz / pap : 0.f;
        acc = 0.f;
        for (int i = s.tid(); i < N; i += s.stride()) {
            p.x[i] += alpha * p.p[i];
            const float r = l0.r[i] - alpha * l0.az[i];
            l0.r[i] = r;
            acc += r * r;
        }
        write_partial(s, slot(p, kRR), acc, sh);
        s.sync();
        rr = total(s, slot(p, kRR), sh);
    }
    if (s.tid() == 0) {
        *p.iters_out = k;
        *p.rr_out = rr;
    }
}

// One call site of the inlined cycle (the start's cycle is the loop's
// first pass) and at least 3 resident blocks per SM keep the kernel at 80
// registers with no spills (two call sites took 128).
__global__ void __launch_bounds__(kThreads, 3)
pcg_segment_kernel(const __grid_constant__ Params p) {
    GridSync s{cg::this_grid()};
    __shared__ float sh[kThreads];
    segment(p, s, sh);
}

// What a lane adds to the batch's base pointers, in floats: lanes are
// contiguous in every per-lane operand.
struct Lanes {
    int scratch;             // the cycle's level buffers (levels ≥ 1: r, za, zb, az; level 0: za, zb, az)
    int cf[kMaxLevels];      // a level's [ν, 2] schedule (0: damped Jacobi)
};

__global__ void __launch_bounds__(kThreads, 3)
pcg_segment_batch_kernel(const __grid_constant__ Params base, const __grid_constant__ Lanes st) {
    __shared__ float sh[kThreads];
    __shared__ float parts[kSlots];
    __shared__ Params p;
    const int* src = reinterpret_cast<const int*>(&base);
    for (int i = threadIdx.x; i < static_cast<int>(sizeof(Params) / sizeof(int)); i += kThreads)
        reinterpret_cast<int*>(&p)[i] = src[i];
    __syncthreads();
    if (threadIdx.x == 0) {
        const size_t lane = blockIdx.x;
        const size_t n0 = static_cast<size_t>(nodes(p.cyc.lv[0]));
        p.x_in += lane * n0;
        p.r_in += lane * n0;
        p.x += lane * n0;
        p.p += lane * n0;
        p.tol2 += lane;
        p.budget += lane;
        p.iters_out += lane;
        p.rr_out += lane;
        p.partials = parts;
        p.capacity = 1;
        for (int l = 0; l < p.cyc.L; ++l) {
            Level& lv = p.cyc.lv[l];
            const size_t n = static_cast<size_t>(nodes(lv));
            lv.op.coeff += lane * n * (lv.op.diag ? 1 : 9);
            lv.sid += lane * n;
            if (lv.cf) lv.cf += lane * st.cf[l];
            lv.r += lane * (l == 0 ? n0 : static_cast<size_t>(st.scratch));
            lv.za += lane * st.scratch;
            lv.zb += lane * st.scratch;
            lv.az += lane * st.scratch;
        }
        const size_t nc = static_cast<size_t>(nodes(p.cyc.lv[p.cyc.L - 1]));
        p.cyc.inv += lane * nc * nc;
    }
    __syncthreads();
    BlockSync s;
    segment(p, s, sh);
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

// The batched segment: lane b's operands start b lanes past the base
// pointers (lane 0's), every per-lane operand [B, ...] contiguous.
//   ptrs: x_in, r_in, tol2 [B], budget [B], x_out, iters_out [B],
//         rr_out [B], rw, p, inv [B, Nc, Nc]; then the cycle's pointers of
//         lane 0 as fi_pcg_segment's (Rs and bands shared by the lanes).
//   ints: B, the floats of level scratch per lane, kMaxLevels schedule
//         strides (floats per lane; 0 under damped Jacobi), then the
//         cycle's ints.
//   w2s:  4 per level, shared.
extern "C" int fi_pcg_segment_batch(const long long* ptrs, const int* ints,
                                    const float* w2s, void* stream) {
    Params p{};
    Lanes st{};
    const int B = ints[0];
    st.scratch = ints[1];
    for (int l = 0; l < kMaxLevels; ++l) st.cf[l] = ints[2 + l];
    if (B < 1 || st.scratch < 0 ||
        !fill_cycle(p.cyc, ptrs + 10, ints + 2 + kMaxLevels, w2s,
                    as_ptr<const float>(ptrs[9])))
        return static_cast<int>(cudaErrorInvalidValue);
    p.capacity = 1;
    p.x_in = as_ptr<const float>(ptrs[0]);
    p.r_in = as_ptr<const float>(ptrs[1]);
    p.tol2 = as_ptr<const float>(ptrs[2]);
    p.budget = as_ptr<const int>(ptrs[3]);
    p.x = as_ptr<float>(ptrs[4]);
    p.iters_out = as_ptr<int>(ptrs[5]);
    p.rr_out = as_ptr<float>(ptrs[6]);
    p.cyc.lv[0].r = as_ptr<float>(ptrs[7]);
    p.p = as_ptr<float>(ptrs[8]);
    pcg_segment_batch_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p, st);
    return static_cast<int>(cudaGetLastError());
}
