// The whole 2-D multigrid cycle for Hopper: z = M⁻¹ r, one symmetric
// V- or W-cycle with damped-Jacobi or Chebyshev smoothing and the dense
// coarsest solve, in ONE cooperative launch.
//
// Replaces three TPU kernels of field_interpolation_tpu/ops/pallas_stencil.py
// that compute the same cycle:
//   _vc_down_call (1052 → 1100) and _vc_up_call (1114 → 1161), the two
//     halves of fused_vcycle_2d (1172), with the XLA coarsest matvec between
//     them: wdepth = 0, ν_pre and ν_post apart;
//   fused_wcycle_2d (1192 → 1238): wdepth > 0, ν_pre = ν_post;
// each in its Jacobi and its Chebyshev mode (the per-level schedules of
// cf_refs, 1059-1098, 1119-1159, 1204-1236), on lumped (diagonal) or
// Galerkin (9-channel) coarse levels.
// The reference splits its V-cycle in two calls only because Mosaic cannot
// reshape (nc0, nc1) → (nc0·nc1, 1) in a kernel (pallas_stencil.py:
// 1008-1013); here the coarsest matvec is one phase of the same launch.
// The cycle itself is mg_cycle2d.cuh's, the one the PCG segment kernel
// (pcg_segment.cu) runs as its preconditioner.
//
// What bounds it on the H100: grid-wide synchronisation, not bytes. Below
// the fine level every phase touches a few hundred to a few thousand nodes,
// and every phase boundary is a grid barrier: a V-cycle at 496² over six
// levels with ν = 3 is 46 phases, a W-cycle (1+2+4+8+16 visits of the
// levels above the coarsest) 310. The whole operand set at 496² (9
// coefficient planes, the level arrays, the dense 256² inverse) is ~12 MB
// and sits in the 50 MB L2.
// What the design does about it: one launch per cycle (the reference's V
// is two calls and an XLA matvec); the W step's residual update shares a
// phase with the prolongation it follows; sweeps ping-pong two buffers so
// each is one phase. No float atomics, no dot products: the result is the
// same bits on every run. A coarse tail in one block or one thread-block
// cluster, without grid barriers, measured no faster on the H100 (PERF.md
// §6): a tail phase costs about what a grid phase does.
#include "mg_cycle2d.cuh"

namespace {

using namespace mg2d;

struct Args {
    Cycle cyc;          // lv[0].r is the input residual (read only)
    float* z_out;
};

__global__ void __launch_bounds__(kThreads)
mg_cycle2d_kernel(const __grid_constant__ Args a) {
    GridSync s{cg::this_grid()};
    __shared__ float sh[kThreads];
    const float* z0 = cycle(s, a.cyc, sh, nullptr);
    // z0 was written before the cycle's last grid barrier.
    for (int i = s.tid(); i < nodes(a.cyc.lv[0]); i += s.stride()) a.z_out[i] = z0[i];
}

}  // namespace

// Host tables, filled by field_interpolation_tpu_torch/ops/cycle.py:
//   ptrs: r, z_out, inv; then the cycle's level, transfer and schedule
//         pointers (mg_cycle2d.cuh:fill_cycle; level 0's r entry is 0: it
//         is r).
//   ints: L, nu_pre, nu_post, wdepth, then n0, n1, diag per level.
//   w2s:  4 per level (w_k² for orders 0..3).
extern "C" int fi_mg_cycle2d(const long long* ptrs, const int* ints, const float* w2s,
                             void* stream) {
    Args a{};
    if (!fill_cycle(a.cyc, ptrs + 3, ints, w2s, as_ptr<const float>(ptrs[2])))
        return static_cast<int>(cudaErrorInvalidValue);
    a.cyc.lv[0].r = as_ptr<float>(ptrs[0]);
    a.z_out = as_ptr<float>(ptrs[1]);
    void* args[] = {&a};
    const int want = (nodes(a.cyc.lv[0]) + kThreads - 1) / kThreads;
    return static_cast<int>(launch_cooperative(reinterpret_cast<const void*>(mg_cycle2d_kernel),
                                               args, want, want, stream));
}
