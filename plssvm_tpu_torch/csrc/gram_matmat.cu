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
//   partials through shared memory, then one atomicAdd per (row, class) and
//   one per (column, class) off the diagonal.  The TPU kernel padded the
//   classes to a multiple of 8 in a class-major (cp, m) layout (its sublane
//   tile) and kept a VMEM-resident column accumulator; neither is carried
//   over: V and out keep the caller's row-major (m, C), and atomics replace
//   the accumulator.
//
// Kernel D, gram_matmat_rect: out = K(P, S) @ A with A (n_s, C) row-major,
//   multiclass and one-vs-one predict.  Replaces the symmetric=False use of
//   kernel_matmat_pallas_dual (csvm._predict_values_pallas).  It is kernel
//   B's 2-D grid (point tiles x support-vector tiles, one linear index) with
//   one atomicAdd per (row, class) per tile.
//
// What bounds them: the Gram tile, 2 * BM^2 * d flops per tile on the CUDA
// cores, as for kernels A and B.  The classes add 2 * BM^2 * C FMAs per tile
// (R^2 per thread and class, one direction each), a reduction per class,
// and 2 * BM * C atomics per off-diagonal tile where kernel A issues 2 * BM.
// The classes are a loop, not a register array, so no per-class state is
// held: the register footprint stays kernel A's, and C does not change how
// the kernel is compiled.  This register tile serves the "highest" tier,
// float32 only; kernels C and D at "f32" (TF32) and "bf16" run on the
// tensor-core tiles of gram_tc.cuh (plssvm_gram_matmat_sym_tf32 / _bf16,
// plssvm_gram_matmat_rect_tc_tf32 / _tc_bf16), D with one atomicAdd per
// (row, class) per run of SV tiles instead of per tile.  Kernels C and D
// in float64 run on the FP64 tensor cores at every tier: the DMMA tiles of
// gram_dmma.cu, behind plssvm_gram_matmat_sym_dmma and
// plssvm_gram_matmat_rect_dmma.
//
// Numerics: as kernels A and B (no fast-math, accurate expf/tanhf).  The
// atomics make the summation order change from run to run.

#include "gram_tc.cuh"

namespace {

template <typename T, int KIND>
__global__ void __launch_bounds__(kThreads * kThreads)
    gram_matmat_sym_kernel(const T* __restrict__ X, const T* __restrict__ sq,
                           const T* __restrict__ V, T* __restrict__ out,
                           int64_t m, int64_t d, int64_t C, int degree,
                           T gamma, T coef0) {
    constexpr int BM = TileEdge<T>::value;
    constexpr int R = BM / kThreads;
    __shared__ Staging<T, BM> staging;
    __shared__ T v_cols[kClassChunk][BM + 1];  // V rows of the column tile
    __shared__ T v_rows[kClassChunk][BM + 1];  // V rows of the row tile
    __shared__ T col_part[kThreads][BM];

    int64_t it, jt;
    upper_triangle_tile(blockIdx.x, it, jt);
    const int64_t row0 = it * BM;
    const int64_t col0 = jt * BM;
    const bool off_diagonal = jt > it;  // uniform per block

    T kv[R][R];
    gram_tile<T, BM>(X, X, m, m, d, row0, col0, staging, kv);
    kernel_tile<T, KIND, BM>(kv, sq, sq, m, m, row0, col0, degree, gamma,
                             coef0);
    sym_class_loop<T, BM>(kv, V, out, m, C, row0, col0, off_diagonal, v_cols,
                          v_rows, col_part);
}

template <typename T, int KIND>
__global__ void __launch_bounds__(kThreads * kThreads)
    gram_matmat_rect_kernel(const T* __restrict__ P, const T* __restrict__ S,
                            const T* __restrict__ sq_p,
                            const T* __restrict__ sq_s,
                            const T* __restrict__ A, T* __restrict__ out,
                            int64_t n_p, int64_t n_s, int64_t d, int64_t C,
                            int64_t n_stiles, int degree, T gamma, T coef0) {
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
    rect_class_loop<T, BM>(kv, A, out, n_p, n_s, C, row0, col0, a_cols);
}

template <typename T, int KIND>
cudaError_t launch_sym(const T* X, const T* sq, const T* V, T* out,
                       int64_t m, int64_t d, int64_t C, int degree, T gamma,
                       T coef0, cudaStream_t stream) {
    constexpr int BM = TileEdge<T>::value;
    const int64_t nt = (m + BM - 1) / BM;
    const int64_t blocks = nt * (nt + 1) / 2;
    if (blocks <= 0 || blocks > INT32_MAX || C <= 0) {
        return cudaErrorInvalidValue;
    }
    gram_matmat_sym_kernel<T, KIND>
        <<<static_cast<unsigned int>(blocks), dim3(kThreads, kThreads), 0,
           stream>>>(X, sq, V, out, m, d, C, degree, gamma, coef0);
    return cudaGetLastError();
}

template <typename T, int KIND>
cudaError_t launch_rect(const T* P, const T* S, const T* sq_p, const T* sq_s,
                        const T* A, T* out, int64_t n_p, int64_t n_s,
                        int64_t d, int64_t C, int degree, T gamma, T coef0,
                        cudaStream_t stream) {
    constexpr int BM = TileEdge<T>::value;
    const int64_t n_stiles = (n_s + BM - 1) / BM;
    const int64_t blocks = ((n_p + BM - 1) / BM) * n_stiles;
    if (blocks <= 0 || blocks > INT32_MAX || C <= 0) {
        return cudaErrorInvalidValue;
    }
    gram_matmat_rect_kernel<T, KIND>
        <<<static_cast<unsigned int>(blocks), dim3(kThreads, kThreads), 0,
           stream>>>(P, S, sq_p, sq_s, A, out, n_p, n_s, d, C, n_stiles,
                     degree, gamma, coef0);
    return cudaGetLastError();
}

template <typename T>
int sym(const T* X, const T* sq, const T* V, T* out, int64_t m, int64_t d,
        int64_t C, int kind, int degree, T gamma, T coef0, void* stream) {
    const auto s = static_cast<cudaStream_t>(stream);
    switch (kind) {
        case kPolynomial:
            return launch_sym<T, kPolynomial>(X, sq, V, out, m, d, C, degree,
                                              gamma, coef0, s);
        case kRbf:
            return launch_sym<T, kRbf>(X, sq, V, out, m, d, C, degree, gamma,
                                       coef0, s);
        case kSigmoid:
            return launch_sym<T, kSigmoid>(X, sq, V, out, m, d, C, degree,
                                           gamma, coef0, s);
        default:
            return cudaErrorInvalidValue;
    }
}

template <typename T>
int rect(const T* P, const T* S, const T* sq_p, const T* sq_s,
         const T* A, T* out, int64_t n_p, int64_t n_s, int64_t d, int64_t C,
         int kind, int degree, T gamma, T coef0, void* stream) {
    const auto s = static_cast<cudaStream_t>(stream);
    switch (kind) {
        case kPolynomial:
            return launch_rect<T, kPolynomial>(
                P, S, sq_p, sq_s, A, out, n_p, n_s, d, C, degree, gamma,
                coef0, s);
        case kRbf:
            return launch_rect<T, kRbf>(P, S, sq_p, sq_s, A, out, n_p, n_s,
                                        d, C, degree, gamma, coef0, s);
        case kSigmoid:
            return launch_rect<T, kSigmoid>(P, S, sq_p, sq_s, A, out, n_p,
                                            n_s, d, C, degree, gamma, coef0,
                                            s);
        default:
            return cudaErrorInvalidValue;
    }
}

}  // namespace

// The C interface: every entry point returns the cudaError_t of its launch
// (0 on success).  out (rows x C, row-major) must hold zeros: both kernels
// accumulate into it.

extern "C" int plssvm_gram_matmat_sym_f32(const float* X, const float* sq,
                                          const float* V, float* out,
                                          int64_t m, int64_t d, int64_t C,
                                          int kind, int degree, float gamma,
                                          float coef0, void* stream) {
    return sym<float>(X, sq, V, out, m, d, C, kind, degree, gamma, coef0,
                      stream);
}

extern "C" int plssvm_gram_matmat_rect_f32(
    const float* P, const float* S, const float* sq_p, const float* sq_s,
    const float* A, float* out, int64_t n_p, int64_t n_s, int64_t d,
    int64_t C, int kind, int degree, float gamma, float coef0, void* stream) {
    return rect<float>(P, S, sq_p, sq_s, A, out, n_p, n_s, d, C, kind, degree,
                       gamma, coef0, stream);
}

// Kernel C on the tensor-core tile (gram_tc.cuh): X the tier's operand copy
// (m, d_pad), TF32-rounded float32 or bf16; sq the float32 X's norms.
extern "C" int plssvm_gram_matmat_sym_tf32(const void* X, const float* sq,
                                           const float* V, float* out,
                                           int64_t m, int64_t d_pad,
                                           int64_t C, int kind, int degree,
                                           float gamma, float coef0,
                                           void* stream) {
    return tc_sym<Tf32Tier>(X, sq, V, out, m, d_pad, C, kind, degree, gamma,
                            coef0, stream);
}

extern "C" int plssvm_gram_matmat_sym_bf16(const void* X, const float* sq,
                                           const float* V, float* out,
                                           int64_t m, int64_t d_pad,
                                           int64_t C, int kind, int degree,
                                           float gamma, float coef0,
                                           void* stream) {
    return tc_sym<Bf16Tier>(X, sq, V, out, m, d_pad, C, kind, degree, gamma,
                            coef0, stream);
}

// Kernel D on the tensor-core tile (gram_tc.cuh): P and S the tier's
// operand copies (n_p, d_pad) and (n_s, d_pad), TF32-rounded float32 or
// bf16; sq_p, sq_s the float32 operands' norms.
extern "C" int plssvm_gram_matmat_rect_tc_tf32(
    const void* P, const void* S, const float* sq_p, const float* sq_s,
    const float* A, float* out, int64_t n_p, int64_t n_s, int64_t d_pad,
    int64_t C, int kind, int degree, float gamma, float coef0, void* stream) {
    return tc_rect<Tf32Tier>(P, S, sq_p, sq_s, A, out, n_p, n_s, d_pad, C, kind,
                             degree, gamma, coef0, stream);
}

extern "C" int plssvm_gram_matmat_rect_tc_bf16(
    const void* P, const void* S, const float* sq_p, const float* sq_s,
    const float* A, float* out, int64_t n_p, int64_t n_s, int64_t d_pad,
    int64_t C, int kind, int degree, float gamma, float coef0, void* stream) {
    return tc_rect<Bf16Tier>(P, S, sq_p, sq_s, A, out, n_p, n_s, d_pad, C, kind,
                             degree, gamma, coef0, stream);
}
