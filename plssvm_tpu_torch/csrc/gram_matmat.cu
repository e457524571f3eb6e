// Gram-kernel block matmats for one-vs-all multiclass training and for
// multiclass and one-vs-one predict, written by hand for NVIDIA Hopper
// (sm_90a).  Bound to PyTorch through a plain C interface and ctypes
// (plssvm_tpu_torch/ops/gram_matmat.py); built by ops/_build.py.  The Gram
// tile, its loader and the kernel epilogue are kernels A and B's, and the
// class loops are shared with the distance matmats G and H (all in
// gram_tile.cuh).
//
// Kernel C, gram_matmat_sym: out = K(X, X) @ V with V (m, C) row-major,
//   every block-CG iteration of a C-class one-vs-all fit.  Replaces the
//   Pallas kernel plssvm_tpu/ops/pallas_matvec.py kernel_matmat_pallas_dual
//   (body _matmat_kernel_dual) with symmetric=True, and the chunk
//   composition kernel_matmat_pallas_big around it: sizes are 64-bit, so one
//   launch covers any m and any C >= 1.  It is kernel A's walk with C
//   right-hand sides: the same 1-D grid over upper-triangle BM x BM tiles,
//   the same register tile.  After the epilogue each thread holds R x R
//   kernel values, which stay in registers while the block loops over the
//   classes: for each class a thread forms R row partials against the V
//   rows of the column tile and R column partials against the V rows of the
//   row tile, both staged transposed in shared memory kClassChunk classes at
//   a time.  Row partials are reduced with a half-warp shuffle, column
//   partials through shared memory, then one slot per (row, class) and
//   one per (column, class) off the diagonal (fixed_sum.cuh).  The TPU
//   kernel padded the classes to a multiple of 8 in a class-major (cp, m)
//   layout (its sublane tile) and kept a VMEM-resident column accumulator;
//   neither is carried over: V and out keep the caller's row-major (m, C),
//   and the slots, summed in a fixed order, replace the accumulator.
//
// Kernel D, gram_matmat_rect: out = K(P, S) @ A with A (n_s, C) row-major,
//   multiclass and one-vs-one predict.  Replaces the symmetric=False use of
//   kernel_matmat_pallas_dual (csvm._predict_values_pallas).  It is kernel
//   B's 2-D grid (point tiles x support-vector tiles, one linear index) with
//   one slot per (row, class) per tile.
//
// What bounds them: the Gram tile, 2 * BM^2 * d flops per tile on the CUDA
// cores, as for kernels A and B.  The classes add 2 * BM^2 * C FMAs per tile
// (R^2 per thread and class, one direction each), a reduction per class,
// and 2 * BM * C slot stores per off-diagonal tile where kernel A issues
// 2 * BM.
// The classes are a loop, not a register array, so no per-class state is
// held: the register footprint stays kernel A's, and C does not change how
// the kernel is compiled.  This register tile is built for float32 only
// and no wrapper launches it (the card tests hold it against the plain
// version, chip_smoke.py times it beside its replacement); kernels C and D
// run on the tensor-core tiles of gram_tc.cuh at every float32 tier
// (plssvm_gram_matmat_sym_tf32 / _bf16 / _tf32x3,
// plssvm_gram_matmat_rect_tc_tf32 / _tc_bf16 / _tc_tf32x3, "highest" as
// three TF32 passes over the split operand), D with one slot per (row,
// class) per run of SV tiles instead of per tile.  Kernels C and D
// in float64 run on the FP64 tensor cores at every tier: the DMMA tiles of
// gram_dmma.cu, behind plssvm_gram_matmat_sym_dmma and
// plssvm_gram_matmat_rect_dmma.
//
// Numerics: as kernels A and B (no fast-math, accurate expf/tanhf).  Every
// sum across blocks is taken in an order fixed by the shapes
// (fixed_sum.cuh).

#include "gram_tc.cuh"

namespace {

template <typename T, int KIND>
__global__ void __launch_bounds__(kThreads * kThreads)
    gram_matmat_sym_kernel(const T* __restrict__ X, const T* __restrict__ sq,
                           const T* __restrict__ V, T* __restrict__ ws,
                           SymPass pass, int64_t m, int64_t d, int64_t C,
                           int degree, T gamma, T coef0) {
    constexpr int BM = TileEdge<T>::value;
    constexpr int R = BM / kThreads;
    __shared__ Staging<T, BM> staging;
    __shared__ T v_cols[kClassChunk][BM + 1];  // V rows of the column tile
    __shared__ T v_rows[kClassChunk][BM + 1];  // V rows of the row tile
    __shared__ T col_part[kThreads][BM];

    int64_t it, jt;
    upper_triangle_tile(pass.first_block() + blockIdx.x, it, jt);
    const int64_t row0 = it * BM;
    const int64_t col0 = jt * BM;

    T kv[R][R];
    gram_tile<T, BM>(X, X, m, m, d, row0, col0, staging, kv);
    kernel_tile<T, KIND, BM>(kv, sq, sq, m, m, row0, col0, degree, gamma,
                             coef0);
    sym_class_loop<T, BM>(kv, V, ws, pass, m, C, it, jt, v_cols, v_rows,
                          col_part);
}

template <typename T, int KIND>
__global__ void __launch_bounds__(kThreads * kThreads)
    gram_matmat_rect_kernel(const T* __restrict__ P, const T* __restrict__ S,
                            const T* __restrict__ sq_p,
                            const T* __restrict__ sq_s,
                            const T* __restrict__ A, T* __restrict__ ws,
                            int64_t ws_rows, int64_t n_p, int64_t n_s,
                            int64_t d, int64_t C, int64_t n_stiles, int degree,
                            T gamma, T coef0) {
    constexpr int BM = TileEdge<T>::value;
    constexpr int R = BM / kThreads;
    __shared__ Staging<T, BM> staging;
    __shared__ T a_cols[kClassChunk][BM + 1];  // A rows of the SV tile

    // consecutive blocks share a point tile and walk the SV tiles
    const int64_t p = blockIdx.x;
    const int64_t row0 = (p / n_stiles) * BM;
    const int64_t col0 = (p % n_stiles) * BM;

    T kv[R][R];
    gram_tile<T, BM>(P, S, n_p, n_s, d, row0, col0, staging, kv);
    kernel_tile<T, KIND, BM>(kv, sq_p, sq_s, n_p, n_s, row0, col0, degree,
                             gamma, coef0);
    rect_class_loop<T, BM>(kv, A, ws, ws_rows, n_p, n_s, C, row0, col0, a_cols);
}

template <typename T, int KIND>
cudaError_t launch_sym(const T* X, const T* sq, const T* V, T* out,
                       int64_t m, int64_t d, int64_t C, int degree, T gamma,
                       T coef0, const Workspace& workspace,
                       cudaStream_t stream) {
    constexpr int BM = TileEdge<T>::value;
    if (m <= 0 || d < 0 || C <= 0) {
        return cudaErrorInvalidValue;
    }
    return run_sym<T>(workspace, m, BM, 1, C, out, stream,
                      [&](const SymPass& pass, T* ws) {
        gram_matmat_sym_kernel<T, KIND>
            <<<static_cast<unsigned int>(pass.blocks()),
               dim3(kThreads, kThreads), 0, stream>>>(
                X, sq, V, ws, pass, m, d, C, degree, gamma, coef0);
        return cudaGetLastError();
    });
}

template <typename T, int KIND>
cudaError_t launch_rect(const T* P, const T* S, const T* sq_p, const T* sq_s,
                        const T* A, T* out, int64_t n_p, int64_t n_s,
                        int64_t d, int64_t C, int degree, T gamma, T coef0,
                        const Workspace& workspace, cudaStream_t stream) {
    constexpr int BM = TileEdge<T>::value;
    if (n_p <= 0 || n_s <= 0 || d < 0 || C <= 0) {
        return cudaErrorInvalidValue;
    }
    const int64_t n_stiles = (n_s + BM - 1) / BM;
    return run_rows<T>(
        workspace, n_p, BM, C, 0, 1, out, nullptr, stream,
        [&](int64_t) { return n_stiles; },
        [&](int64_t row0, int64_t rows, T* ws, T*, int64_t ws_rows) {
            const int64_t blocks = ((rows + BM - 1) / BM) * n_stiles;
            if (blocks > INT32_MAX) {
                return cudaErrorInvalidValue;
            }
            gram_matmat_rect_kernel<T, KIND>
                <<<static_cast<unsigned int>(blocks), dim3(kThreads, kThreads),
                   0, stream>>>(P + row0 * d, S, sq_p + row0, sq_s, A, ws,
                                ws_rows, rows, n_s, d, C, n_stiles, degree,
                                gamma, coef0);
            return cudaGetLastError();
        });
}

template <typename T>
int sym(const T* X, const T* sq, const T* V, T* out, int64_t m, int64_t d,
        int64_t C, int kind, int degree, T gamma, T coef0,
        const Workspace& ws, void* stream) {
    const auto s = static_cast<cudaStream_t>(stream);
    switch (kind) {
        case kPolynomial:
            return launch_sym<T, kPolynomial>(X, sq, V, out, m, d, C, degree,
                                              gamma, coef0, ws, s);
        case kRbf:
            return launch_sym<T, kRbf>(X, sq, V, out, m, d, C, degree, gamma,
                                       coef0, ws, s);
        case kSigmoid:
            return launch_sym<T, kSigmoid>(X, sq, V, out, m, d, C, degree,
                                           gamma, coef0, ws, s);
        default:
            return cudaErrorInvalidValue;
    }
}

template <typename T>
int rect(const T* P, const T* S, const T* sq_p, const T* sq_s,
         const T* A, T* out, int64_t n_p, int64_t n_s, int64_t d, int64_t C,
         int kind, int degree, T gamma, T coef0, const Workspace& ws,
         void* stream) {
    const auto s = static_cast<cudaStream_t>(stream);
    switch (kind) {
        case kPolynomial:
            return launch_rect<T, kPolynomial>(
                P, S, sq_p, sq_s, A, out, n_p, n_s, d, C, degree, gamma,
                coef0, ws, s);
        case kRbf:
            return launch_rect<T, kRbf>(P, S, sq_p, sq_s, A, out, n_p, n_s,
                                        d, C, degree, gamma, coef0, ws, s);
        case kSigmoid:
            return launch_rect<T, kSigmoid>(P, S, sq_p, sq_s, A, out, n_p,
                                            n_s, d, C, degree, gamma, coef0,
                                            ws, s);
        default:
            return cudaErrorInvalidValue;
    }
}

}  // namespace

// The C interface: every entry point returns the cudaError_t of its
// launches (0 on success).  out (rows x C, row-major) must hold zeros: the
// sums are added to it.  workspace holds *workspace_bytes bytes; a null
// workspace asks for the bytes the call needs, written to
// *workspace_bytes, and launches nothing (fixed_sum.cuh).

extern "C" int plssvm_gram_matmat_sym_f32(const float* X, const float* sq,
                                          const float* V, float* out,
                                          int64_t m, int64_t d, int64_t C,
                                          int kind, int degree, float gamma,
                                          float coef0, void* workspace,
    int64_t* workspace_bytes, void* stream) {
    return sym<float>(X, sq, V, out, m, d, C, kind, degree, gamma, coef0,
        Workspace{workspace, workspace_bytes}, stream);
}

extern "C" int plssvm_gram_matmat_rect_f32(
    const float* P, const float* S, const float* sq_p, const float* sq_s,
    const float* A, float* out, int64_t n_p, int64_t n_s, int64_t d,
    int64_t C, int kind, int degree, float gamma, float coef0, void* workspace,
    int64_t* workspace_bytes, void* stream) {
    return rect<float>(P, S, sq_p, sq_s, A, out, n_p, n_s, d, C, kind, degree,
                       gamma, coef0,
        Workspace{workspace, workspace_bytes}, stream);
}

// Kernel C on the tensor-core tile (gram_tc.cuh): X the tier's operand copy
// (m, d_pad), TF32-rounded float32 or bf16; sq the float32 X's norms.
extern "C" int plssvm_gram_matmat_sym_tf32(const void* X, const float* sq,
                                           const float* V, float* out,
                                           int64_t m, int64_t d_pad,
                                           int64_t C, int kind, int degree,
                                           float gamma, float coef0,
                                           void* workspace,
                                           int64_t* workspace_bytes,
                                           void* stream) {
    return tc_sym<Tf32Tier>(X, sq, V, out, m, d_pad, C, kind, degree, gamma,
                            coef0,
        Workspace{workspace, workspace_bytes}, stream);
}

extern "C" int plssvm_gram_matmat_sym_bf16(const void* X, const float* sq,
                                           const float* V, float* out,
                                           int64_t m, int64_t d_pad,
                                           int64_t C, int kind, int degree,
                                           float gamma, float coef0,
                                           void* workspace,
                                           int64_t* workspace_bytes,
                                           void* stream) {
    return tc_sym<Bf16Tier>(X, sq, V, out, m, d_pad, C, kind, degree, gamma,
                            coef0,
        Workspace{workspace, workspace_bytes}, stream);
}

// Kernel C at "highest" on the same tile in three TF32 passes: X the split
// stack (2, m, d_pad) [hi; lo] of the float32 X; sq the float32 X's norms.
extern "C" int plssvm_gram_matmat_sym_tf32x3(const void* X, const float* sq,
                                             const float* V, float* out,
                                             int64_t m, int64_t d_pad,
                                             int64_t C, int kind, int degree,
                                             float gamma, float coef0,
                                             void* workspace,
                                             int64_t* workspace_bytes,
                                             void* stream) {
    return tc_sym<Tf32x3Tier>(X, sq, V, out, m, d_pad, C, kind, degree, gamma,
                              coef0,
        Workspace{workspace, workspace_bytes}, stream);
}

// Kernel D on the tensor-core tile (gram_tc.cuh): P and S the tier's
// operand copies (n_p, d_pad) and (n_s, d_pad), TF32-rounded float32 or
// bf16; sq_p, sq_s the float32 operands' norms.
extern "C" int plssvm_gram_matmat_rect_tc_tf32(
    const void* P, const void* S, const float* sq_p, const float* sq_s,
    const float* A, float* out, int64_t n_p, int64_t n_s, int64_t d_pad,
    int64_t C, int kind, int degree, float gamma, float coef0, void* workspace,
    int64_t* workspace_bytes, void* stream) {
    return tc_rect<Tf32Tier>(P, S, sq_p, sq_s, A, out, n_p, n_s, d_pad, C, kind,
                             degree, gamma, coef0,
        Workspace{workspace, workspace_bytes}, stream);
}

extern "C" int plssvm_gram_matmat_rect_tc_bf16(
    const void* P, const void* S, const float* sq_p, const float* sq_s,
    const float* A, float* out, int64_t n_p, int64_t n_s, int64_t d_pad,
    int64_t C, int kind, int degree, float gamma, float coef0, void* workspace,
    int64_t* workspace_bytes, void* stream) {
    return tc_rect<Bf16Tier>(P, S, sq_p, sq_s, A, out, n_p, n_s, d_pad, C, kind,
                             degree, gamma, coef0,
        Workspace{workspace, workspace_bytes}, stream);
}

// Kernel D at "highest" on the same tile in three TF32 passes: P and S the
// split stacks (2, n_p, d_pad) and (2, n_s, d_pad).
extern "C" int plssvm_gram_matmat_rect_tc_tf32x3(
    const void* P, const void* S, const float* sq_p, const float* sq_s,
    const float* A, float* out, int64_t n_p, int64_t n_s, int64_t d_pad,
    int64_t C, int kind, int degree, float gamma, float coef0, void* workspace,
    int64_t* workspace_bytes, void* stream) {
    return tc_rect<Tf32x3Tier>(P, S, sq_p, sq_s, A, out, n_p, n_s, d_pad, C,
                               kind, degree, gamma, coef0,
        Workspace{workspace, workspace_bytes}, stream);
}
