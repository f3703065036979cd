// The sharded apply for Hopper: out = (S + DᵀWD) x on one shard's block of a
// 2-D or 3-D grid, read from the block extended by r nodes of neighbour data.
//
// Replaces two TPU kernels of field_interpolation_tpu/ops/pallas_stencil.py:
// fused_normal_apply_ext (378, pallas_call 462: the whole extended block in
// VMEM; 3^D-channel or diagonal data; 2-D and 3-D) and
// fused_normal_apply_ext_striped (1282, pallas_call 1387: a 2-D block too
// large for VMEM, striped along axis 0, whose axis-0 halos arrive as two
// separate slabs). On the H100 nothing has to fit a block's memory, so each
// is one launch over the whole block, one thread per local output node.
//
// The smoothness windows are bounded by the node's GLOBAL coordinate and the
// GLOBAL extent (axis_normal of normal_apply.cuh, given gs[d] + i and
// grid_shape[d]): a shard seam is interior, only the global edge drops rows,
// which is the reference's global window mask. The data term is NOT bounded
// by the block: across a seam a pair reads the halo, and where a pair leaves
// the global grid its coefficient is zero (the halo there holds zeros).
//
// What bounds it on the H100: memory, as the whole-grid apply: 3^D
// coefficient planes per node (36 B/node in 2-D, 108 in 3-D) plus x and the
// output; a 2048² 9-channel block moves ~185 MB (0.055 ms at 3.35 TB/s).
// What the design does about it: gather form (no write conflicts), coalesced
// along the minor axis, neighbours of x reread through L1/L2. A shared-memory
// tile or TMA is later work.
#include "normal_apply.cuh"

namespace {

struct ExtOp {
    const float* coeff;  // [3^D, *local] channel-major, or [*local] when diag
    int diag;
    float w2[4];
    int r;               // halo width of the extended operand(s)
    int n0, n1, n2;      // local extents (n2 = 1 in 2-D)
    int g0, g1, g2;      // global coordinate of the block's first node
    int N0, N1, N2;      // global extents
};

template <int L>
__device__ __forceinline__ float smooth_order(const ExtOp& op, const float* x, int fe,
                                              int i0, int i1, int i2, int st0, int st1,
                                              int ndim) {
    float s = axis_normal<L>(x, fe, op.g0 + i0, op.N0, st0)
              + axis_normal<L>(x, fe, op.g1 + i1, op.N1, st1);
    if (ndim == 3) s += axis_normal<L>(x, fe, op.g2 + i2, op.N2, 1);
    return s;
}

// S x at a node whose value sits at xe[fe], with strides st0, st1 (and 1)
// inside the extended block.
__device__ __forceinline__ float smooth_ext(const ExtOp& op, const float* __restrict__ xe,
                                            int fe, int i0, int i1, int i2, int st0,
                                            int st1, int ndim) {
    float out = op.w2[0] != 0.f ? op.w2[0] * xe[fe] : 0.f;
    if (op.w2[1] != 0.f) out += op.w2[1] * smooth_order<2>(op, xe, fe, i0, i1, i2, st0, st1, ndim);
    if (op.w2[2] != 0.f) out += op.w2[2] * smooth_order<3>(op, xe, fe, i0, i1, i2, st0, st1, ndim);
    if (op.w2[3] != 0.f) out += op.w2[3] * smooth_order<4>(op, xe, fe, i0, i1, i2, st0, st1, ndim);
    return out;
}

__global__ void apply_ext_2d(const float* __restrict__ xe, ExtOp op,
                             float* __restrict__ out) {
    const int N = op.n0 * op.n1;
    const int idx = blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= N) return;
    const int i0 = idx / op.n1, i1 = idx % op.n1;
    const int se0 = op.n1 + 2 * op.r;
    const int fe = (i0 + op.r) * se0 + (i1 + op.r);
    float acc = smooth_ext(op, xe, fe, i0, i1, 0, se0, 1, 2);
    if (op.diag) {
        acc += op.coeff[idx] * xe[fe];
    } else {
        const float* c = op.coeff + idx;
#pragma unroll
        for (int o = 0; o < 9; ++o)
            acc += c[o * N] * xe[fe + (o / 3 - 1) * se0 + (o % 3 - 1)];
    }
    out[idx] = acc;
}

// Node indices are 32-bit; channel offsets o·N are 64-bit (27·N passes 2³¹).
__global__ void apply_ext_3d(const float* __restrict__ xe, ExtOp op,
                             float* __restrict__ out) {
    const int N = op.n0 * op.n1 * op.n2;
    const int idx = blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= N) return;
    const int i2 = idx % op.n2, t = idx / op.n2;
    const int i1 = t % op.n1, i0 = t / op.n1;
    const int se1 = op.n2 + 2 * op.r;
    const int se0 = (op.n1 + 2 * op.r) * se1;
    const int fe = (i0 + op.r) * se0 + (i1 + op.r) * se1 + (i2 + op.r);
    float acc = smooth_ext(op, xe, fe, i0, i1, i2, se0, se1, 3);
    if (op.diag) {
        acc += op.coeff[idx] * xe[fe];
    } else {
        const float* c = op.coeff + idx;
        const long long NN = N;
#pragma unroll
        for (int o = 0; o < 27; ++o)
            acc += c[o * NN] * xe[fe + (o / 9 - 1) * se0 + ((o / 3) % 3 - 1) * se1 + (o % 3 - 1)];
    }
    out[idx] = acc;
}

// Row i0 ∈ [−r, n0 + r) of the striped form's extended block: the top slab,
// the block extended along axis 1, or the bottom slab. Rows are W wide.
struct Rows {
    const float* x1;
    const float* top;
    const float* bot;
    int n0, r, W;
    __device__ __forceinline__ const float* operator()(int i0) const {
        if (i0 < 0) return top + (r + i0) * W;
        if (i0 < n0) return x1 + i0 * W;
        return bot + (i0 - n0) * W;
    }
};

template <int L>
__device__ __forceinline__ float striped_order(const ExtOp& op, const Rows& rows, int i0,
                                               int i1, int col) {
    // Along axis 0 the same windows as axis_normal's, with rows taken from
    // the three operands instead of one strided array.
    return axis_normal<L>([&](int d) { return rows(i0 + d)[col]; }, op.g0 + i0, op.N0)
           + axis_normal<L>(rows(i0), col, op.g1 + i1, op.N1, 1);
}

__global__ void apply_ext_striped(Rows rows, ExtOp op, float* __restrict__ out) {
    const int N = op.n0 * op.n1;
    const int idx = blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= N) return;
    const int i0 = idx / op.n1, i1 = idx % op.n1;
    const int col = i1 + op.r;
    const float* row = rows(i0);
    float acc = op.w2[0] != 0.f ? op.w2[0] * row[col] : 0.f;
    if (op.w2[1] != 0.f) acc += op.w2[1] * striped_order<2>(op, rows, i0, i1, col);
    if (op.w2[2] != 0.f) acc += op.w2[2] * striped_order<3>(op, rows, i0, i1, col);
    if (op.w2[3] != 0.f) acc += op.w2[3] * striped_order<4>(op, rows, i0, i1, col);
    const float* c = op.coeff + idx;
#pragma unroll
    for (int o = 0; o < 9; ++o) acc += c[o * N] * rows(i0 + o / 3 - 1)[col + o % 3 - 1];
    out[idx] = acc;
}

ExtOp make_op(const float* coeff, int diag, float w2_0, float w2_1, float w2_2,
              float w2_3, int r, int ndim, int n0, int n1, int n2, int g0, int g1,
              int g2, int N0, int N1, int N2) {
    const bool three = ndim == 3;
    return ExtOp{coeff, diag, {w2_0, w2_1, w2_2, w2_3}, r, n0, n1, three ? n2 : 1,
                 g0, g1, three ? g2 : 0, N0, N1, three ? N2 : 1};
}

unsigned blocks_for(long long n, int threads) {
    return static_cast<unsigned>((n + threads - 1) / threads);
}

}  // namespace

// x_ext [*(local + 2r)], coeff [3^D, *local] or [*local] (diag), out [*local].
// ndim 2: (n0, n1), (g0, g1), (N0, N1); the third of each is ignored.
extern "C" int fi_normal_apply_ext(const float* x_ext, const float* coeff, float* out,
                                   int ndim, int n0, int n1, int n2, int g0, int g1,
                                   int g2, int N0, int N1, int N2, int r, float w2_0,
                                   float w2_1, float w2_2, float w2_3, int diag,
                                   void* stream) {
    if (ndim != 2 && ndim != 3) return static_cast<int>(cudaErrorInvalidValue);
    const ExtOp op = make_op(coeff, diag, w2_0, w2_1, w2_2, w2_3, r, ndim, n0, n1, n2,
                             g0, g1, g2, N0, N1, N2);
    const int threads = 256;
    const unsigned blocks = blocks_for(static_cast<long long>(n0) * n1 * op.n2, threads);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (ndim == 2)
        apply_ext_2d<<<blocks, threads, 0, s>>>(x_ext, op, out);
    else
        apply_ext_3d<<<blocks, threads, 0, s>>>(x_ext, op, out);
    return static_cast<int>(cudaGetLastError());
}

// x_ext1 [n0, n1 + 2r], from_top / from_bot [r, n1 + 2r], coeff [9, n0, n1].
extern "C" int fi_normal_apply_ext_striped(const float* x_ext1, const float* from_top,
                                           const float* from_bot, const float* coeff,
                                           float* out, int n0, int n1, int g0, int g1,
                                           int N0, int N1, int r, float w2_0, float w2_1,
                                           float w2_2, float w2_3, void* stream) {
    const ExtOp op = make_op(coeff, 0, w2_0, w2_1, w2_2, w2_3, r, 2, n0, n1, 1, g0, g1,
                             0, N0, N1, 1);
    const Rows rows{x_ext1, from_top, from_bot, n0, r, n1 + 2 * r};
    const int threads = 256;
    apply_ext_striped<<<blocks_for(static_cast<long long>(n0) * n1, threads), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(rows, op, out);
    return static_cast<int>(cudaGetLastError());
}
