// Gram-kernel matvecs for LS-SVM training and predict, written by hand for
// NVIDIA Hopper (sm_90a).  Bound to PyTorch through a plain C interface and
// ctypes (plssvm_tpu_torch/ops/gram_matvec.py); built by ops/_build.py.
//
// Kernel A, gram_matvec_sym: out = K(X, X) @ v, every CG iteration.
//   Replaces the Pallas kernel plssvm_tpu/ops/pallas_matvec.py
//   kernel_matvec_pallas_dual (body _matvec_kernel_dual) with symmetric=True,
//   and the chunk composition kernel_matvec_pallas_big around it: sizes are
//   64-bit here, so one launch covers any m.  Its design follows PLSSVM's own
//   CUDA svm_kernel.cu, not the Pallas block walk: the grid is the upper
//   triangle of BM x BM tiles (j >= i).  A block stages KC-wide feature
//   chunks of both row tiles in shared memory and accumulates the Gram tile
//   in registers (R x R per thread), applies the kernel epilogue (the same
//   formulas as kernel_functions.apply_kernel_to_gram; RBF uses
//   sq_i + sq_j - 2 g), and writes the row sums K_tile @ v_j of rows i to
//   their slots for partner tile j.  Off the diagonal (j > i) it also
//   writes the column sums K_tile^T @ v_i of rows j to their slots for
//   partner i; the diagonal tile contributes rows only.  fixed_sum.cuh then
//   adds each row's slots in partner order: the fixed order of the TPU
//   kernel's resident column accumulator, without its serial grid.
//   kernel_matvec_pallas, the JAX package's thin wrapper that routes
//   K(X, X) @ v to the same symmetric kernel, is ported as
//   ops/gram_matvec.py kernel_matvec: one launch of kernel A.
//
// Kernel B, gram_matvec_rect: out = K(P, S) @ a, binary predict.
//   Replaces the non-symmetric branch of kernel_matvec_pallas_rect in the
//   same file (bodies _matvec_kernel_fulld and _matvec_kernel_blocked).  One
//   kernel loops over feature chunks for any d, so the full-d / blocked split
//   disappears.  The grid is 2-D (point tiles x support-vector tiles, walked
//   as one linear index) with a slot per row and SV tile, not one block per
//   point tile looping over all SV tiles: predicting a couple of thousand
//   points would give the latter ~16 blocks for 132 SMs.  The price is the
//   slots' bytes and a second launch that sums them, as in kernel A.  (The
//   tensor-core tile of
//   the "f32" and "bf16" tiers walks short runs of SV tiles per block
//   instead, see gram_tc.cuh.)
//
// Both kernels mask the ragged edges of rows and features themselves, so
// the caller pads nothing.  The Gram tile, its loader, the kernel function
// and the triangle walk are in gram_tile.cuh, shared with kernels C and D
// (gram_matmat.cu) and E-H (distance.cu).  The epilogue here stays fused with the contraction:
// applying it to the whole tile first (gram_tile.cuh kernel_tile, as C and
// D must, since they contract the tile once per class) made kernel A 6.5 %
// slower on an H100.
//
// What bounds them: a Gram tile costs 2 * BM^2 * d flops over 2 * BM * d
// operand loads, so at the widths LS-SVM trains at (d in the hundreds) both
// kernels are bound by fp32 FMA throughput on the CUDA cores, not by
// memory.  The register tile (R x R accumulators per thread, fed from
// shared memory) is what this version does about it; it is compiled for
// float32 only and no wrapper launches it: it stays built, held against
// the plain version by the card tests and timed by chip_smoke.py beside
// the tensor-core tiles that replaced it at "highest".  Kernels A and B
// run on the tensor cores at every float32 tier: the wgmma tiles of
// gram_tc.cuh, behind plssvm_gram_matvec_sym_tf32 / _bf16 / _tf32x3 and
// plssvm_gram_matvec_rect_tc_tf32 / _tc_bf16 / _tc_tf32x3 (they take the
// wrapper's operand copies of X, or of P and S: TF32-rounded, bf16, or
// the split [hi; lo] stack of "highest").  Kernels A and B in float64 run on
// the FP64 tensor cores at every tier: the DMMA tiles of gram_dmma.cu,
// behind plssvm_gram_matvec_sym_dmma and plssvm_gram_matvec_rect_dmma.
//
// Numerics: no fast-math.  expf/tanhf are the accurate library functions,
// to match the reference's epilogue; nvcc's
// default FMA contraction applies to the Gram sums as it does in any GEMM.

#include "gram_tc.cuh"

namespace {

template <typename T, int KIND>
__global__ void __launch_bounds__(kThreads * kThreads)
    gram_matvec_sym_kernel(const T* __restrict__ X, const T* __restrict__ sq,
                           const T* __restrict__ v, T* __restrict__ ws,
                           SymPass pass, int64_t m, int64_t d, int degree,
                           T gamma, T coef0) {
    constexpr int BM = TileEdge<T>::value;
    constexpr int R = BM / kThreads;
    __shared__ Staging<T, BM> staging;
    __shared__ T col_part[kThreads][BM];

    int64_t it, jt;
    upper_triangle_tile(pass.first_block() + blockIdx.x, it, jt);
    const int64_t row0 = it * BM;
    const int64_t col0 = jt * BM;

    T acc[R][R];
    gram_tile<T, BM>(X, X, m, m, d, row0, col0, staging, acc);

    const int tx = threadIdx.x;
    const int ty = threadIdx.y;
    bool row_ok[R];
    bool col_ok[R];
    T sq_r[R], v_r[R], sq_c[R], v_c[R];
#pragma unroll
    for (int a = 0; a < R; ++a) {
        const int64_t r = row0 + ty + kThreads * a;
        row_ok[a] = r < m;
        sq_r[a] = row_ok[a] ? sq[r] : T(0);
        v_r[a] = row_ok[a] ? v[r] : T(0);
    }
#pragma unroll
    for (int b = 0; b < R; ++b) {
        const int64_t c = col0 + tx + kThreads * b;
        col_ok[b] = c < m;
        sq_c[b] = col_ok[b] ? sq[c] : T(0);
        v_c[b] = col_ok[b] ? v[c] : T(0);
    }
    T row_sum[R];
    T col_sum[R];
#pragma unroll
    for (int a = 0; a < R; ++a) {
        row_sum[a] = T(0);
        col_sum[a] = T(0);
    }
#pragma unroll
    for (int a = 0; a < R; ++a) {
#pragma unroll
        for (int b = 0; b < R; ++b) {
            const T kval = (row_ok[a] && col_ok[b])
                ? apply_kernel<T, KIND>(acc[a][b], sq_r[a], sq_c[b], gamma,
                                        coef0, degree)
                : T(0);
            row_sum[a] += kval * v_c[b];
            col_sum[b] += kval * v_r[a];
        }
    }
#pragma unroll
    for (int a = 0; a < R; ++a) {
        const T total = half_warp_sum(row_sum[a]);
        if (tx == 0 && row_ok[a]) {
            ws[pass.slot(row0 + ty + kThreads * a, jt)] = total;
        }
    }
    if (jt > it) {  // uniform per block
#pragma unroll
        for (int b = 0; b < R; ++b) {
            col_part[ty][tx + kThreads * b] = col_sum[b];
        }
        __syncthreads();
        for (int c = ty * kThreads + tx; c < BM; c += kThreads * kThreads) {
            T total = T(0);
#pragma unroll
            for (int y = 0; y < kThreads; ++y) {
                total += col_part[y][c];
            }
            if (col0 + c < m) {
                ws[pass.slot(col0 + c, it)] = total;
            }
        }
    }
}

template <typename T, int KIND>
__global__ void __launch_bounds__(kThreads * kThreads)
    gram_matvec_rect_kernel(const T* __restrict__ P, const T* __restrict__ S,
                            const T* __restrict__ sq_p,
                            const T* __restrict__ sq_s,
                            const T* __restrict__ a_s, T* __restrict__ ws,
                            int64_t ws_rows, int64_t n_p, int64_t n_s,
                            int64_t d, int64_t n_stiles, int degree, T gamma,
                            T coef0) {
    constexpr int BM = TileEdge<T>::value;
    constexpr int R = BM / kThreads;
    __shared__ Staging<T, BM> staging;

    // consecutive blocks share a point tile and walk the SV tiles
    const int64_t p = blockIdx.x;
    const int64_t row0 = (p / n_stiles) * BM;
    const int64_t col0 = (p % n_stiles) * BM;
    T* slot = ws + (p % n_stiles) * ws_rows;

    T acc[R][R];
    gram_tile<T, BM>(P, S, n_p, n_s, d, row0, col0, staging, acc);

    const int tx = threadIdx.x;
    const int ty = threadIdx.y;
    bool row_ok[R];
    bool col_ok[R];
    T sq_r[R], sq_c[R], w_c[R];
#pragma unroll
    for (int a = 0; a < R; ++a) {
        const int64_t r = row0 + ty + kThreads * a;
        row_ok[a] = r < n_p;
        sq_r[a] = row_ok[a] ? sq_p[r] : T(0);
    }
#pragma unroll
    for (int b = 0; b < R; ++b) {
        const int64_t c = col0 + tx + kThreads * b;
        col_ok[b] = c < n_s;
        sq_c[b] = col_ok[b] ? sq_s[c] : T(0);
        w_c[b] = col_ok[b] ? a_s[c] : T(0);
    }
#pragma unroll
    for (int a = 0; a < R; ++a) {
        T row_sum = T(0);
#pragma unroll
        for (int b = 0; b < R; ++b) {
            const T kval = (row_ok[a] && col_ok[b])
                ? apply_kernel<T, KIND>(acc[a][b], sq_r[a], sq_c[b], gamma,
                                        coef0, degree)
                : T(0);
            row_sum += kval * w_c[b];
        }
        const T total = half_warp_sum(row_sum);
        if (tx == 0 && row_ok[a]) {
            slot[row0 + ty + kThreads * a] = total;
        }
    }
}

template <typename T, int KIND>
cudaError_t launch_sym(const T* X, const T* sq, const T* v, T* out, int64_t m,
                       int64_t d, int degree, T gamma, T coef0,
                       const Workspace& workspace, cudaStream_t stream) {
    constexpr int BM = TileEdge<T>::value;
    if (m <= 0 || d < 0) {
        return cudaErrorInvalidValue;
    }
    return run_sym<T>(workspace, m, BM, 1, 1, out, stream,
                      [&](const SymPass& pass, T* ws) {
        gram_matvec_sym_kernel<T, KIND>
            <<<static_cast<unsigned int>(pass.blocks()),
               dim3(kThreads, kThreads), 0, stream>>>(
                X, sq, v, ws, pass, m, d, degree, gamma, coef0);
        return cudaGetLastError();
    });
}

template <typename T, int KIND>
cudaError_t launch_rect(const T* P, const T* S, const T* sq_p, const T* sq_s,
                        const T* a_s, T* out, int64_t n_p, int64_t n_s,
                        int64_t d, int degree, T gamma, T coef0,
                        const Workspace& workspace, cudaStream_t stream) {
    constexpr int BM = TileEdge<T>::value;
    if (n_p <= 0 || n_s <= 0 || d < 0) {
        return cudaErrorInvalidValue;
    }
    const int64_t n_stiles = (n_s + BM - 1) / BM;
    return run_rows<T>(
        workspace, n_p, BM, 1, 0, 1, out, nullptr, stream,
        [&](int64_t) { return n_stiles; },
        [&](int64_t row0, int64_t rows, T* ws, T*, int64_t ws_rows) {
            const int64_t blocks = ((rows + BM - 1) / BM) * n_stiles;
            if (blocks > INT32_MAX) {
                return cudaErrorInvalidValue;
            }
            gram_matvec_rect_kernel<T, KIND>
                <<<static_cast<unsigned int>(blocks), dim3(kThreads, kThreads),
                   0, stream>>>(P + row0 * d, S, sq_p + row0, sq_s, a_s, ws,
                                ws_rows, rows, n_s, d, n_stiles, degree, gamma,
                                coef0);
            return cudaGetLastError();
        });
}

template <typename T>
int sym(const T* X, const T* sq, const T* v, T* out, int64_t m, int64_t d,
        int kind, int degree, T gamma, T coef0, const Workspace& ws,
        void* stream) {
    const auto s = static_cast<cudaStream_t>(stream);
    switch (kind) {
        case kPolynomial:
            return launch_sym<T, kPolynomial>(X, sq, v, out, m, d, degree,
                                              gamma, coef0, ws, s);
        case kRbf:
            return launch_sym<T, kRbf>(X, sq, v, out, m, d, degree, gamma,
                                       coef0, ws, s);
        case kSigmoid:
            return launch_sym<T, kSigmoid>(X, sq, v, out, m, d, degree, gamma,
                                           coef0, ws, s);
        default:
            return cudaErrorInvalidValue;
    }
}

template <typename T>
int rect(const T* P, const T* S, const T* sq_p, const T* sq_s,
         const T* a_s, T* out, int64_t n_p, int64_t n_s, int64_t d, int kind,
         int degree, T gamma, T coef0, const Workspace& ws, void* stream) {
    const auto s = static_cast<cudaStream_t>(stream);
    switch (kind) {
        case kPolynomial:
            return launch_rect<T, kPolynomial>(P, S, sq_p, sq_s, a_s, out,
                                               n_p, n_s, d, degree, gamma,
                                               coef0, ws, s);
        case kRbf:
            return launch_rect<T, kRbf>(P, S, sq_p, sq_s, a_s, out, n_p,
                                        n_s, d, degree, gamma, coef0, ws, s);
        case kSigmoid:
            return launch_rect<T, kSigmoid>(P, S, sq_p, sq_s, a_s, out,
                                            n_p, n_s, d, degree, gamma, coef0,
                                            ws, s);
        default:
            return cudaErrorInvalidValue;
    }
}

}  // namespace

// The C interface: every entry point returns the cudaError_t of its
// launches (0 on success).  out must hold zeros: the sums are added to it.
// workspace holds *workspace_bytes bytes; a null workspace asks for the
// bytes the call needs, written to *workspace_bytes, and launches nothing
// (fixed_sum.cuh).

extern "C" int plssvm_gram_matvec_sym_f32(const float* X, const float* sq,
                                          const float* v, float* out,
                                          int64_t m, int64_t d, int kind,
                                          int degree, float gamma,
                                          float coef0, void* workspace,
    int64_t* workspace_bytes, void* stream) {
    return sym<float>(X, sq, v, out, m, d, kind, degree, gamma, coef0,
        Workspace{workspace, workspace_bytes}, stream);
}

extern "C" int plssvm_gram_matvec_rect_f32(
    const float* P, const float* S, const float* sq_p, const float* sq_s,
    const float* a_s, float* out, int64_t n_p, int64_t n_s, int64_t d,
    int kind, int degree, float gamma, float coef0, void* workspace,
    int64_t* workspace_bytes, void* stream) {
    return rect<float>(P, S, sq_p, sq_s, a_s, out, n_p, n_s, d, kind, degree,
                       gamma, coef0,
        Workspace{workspace, workspace_bytes}, stream);
}

// Kernel A on the tensor-core tile (gram_tc.cuh): X the tier's operand copy
// (m, d_pad), TF32-rounded float32 or bf16; sq the float32 X's norms.
extern "C" int plssvm_gram_matvec_sym_tf32(const void* X, const float* sq,
                                           const float* v, float* out,
                                           int64_t m, int64_t d_pad,
                                           int kind, int degree, float gamma,
                                           float coef0, void* workspace,
    int64_t* workspace_bytes, void* stream) {
    return tc_sym<Tf32Tier>(X, sq, v, out, m, d_pad, 1, kind, degree, gamma,
                            coef0,
        Workspace{workspace, workspace_bytes}, stream);
}

extern "C" int plssvm_gram_matvec_sym_bf16(const void* X, const float* sq,
                                           const float* v, float* out,
                                           int64_t m, int64_t d_pad,
                                           int kind, int degree, float gamma,
                                           float coef0, void* workspace,
    int64_t* workspace_bytes, void* stream) {
    return tc_sym<Bf16Tier>(X, sq, v, out, m, d_pad, 1, kind, degree, gamma,
                            coef0,
        Workspace{workspace, workspace_bytes}, stream);
}

// Kernel A at "highest" on the same tile in three TF32 passes: X the split
// stack (2, m, d_pad) [hi; lo] of the float32 X; sq the float32 X's norms.
extern "C" int plssvm_gram_matvec_sym_tf32x3(const void* X, const float* sq,
                                             const float* v, float* out,
                                             int64_t m, int64_t d_pad,
                                             int kind, int degree, float gamma,
                                             float coef0, void* workspace,
    int64_t* workspace_bytes, void* stream) {
    return tc_sym<Tf32x3Tier>(X, sq, v, out, m, d_pad, 1, kind, degree, gamma,
                              coef0,
        Workspace{workspace, workspace_bytes}, stream);
}

// Kernel B on the tensor-core tile (gram_tc.cuh): P and S the tier's
// operand copies (n_p, d_pad) and (n_s, d_pad), TF32-rounded float32 or
// bf16; sq_p, sq_s the float32 operands' norms.
extern "C" int plssvm_gram_matvec_rect_tc_tf32(
    const void* P, const void* S, const float* sq_p, const float* sq_s,
    const float* a_s, float* out, int64_t n_p, int64_t n_s, int64_t d_pad,
    int kind, int degree, float gamma, float coef0, void* workspace,
    int64_t* workspace_bytes, void* stream) {
    return tc_rect<Tf32Tier>(P, S, sq_p, sq_s, a_s, out, n_p, n_s, d_pad, 1,
                             kind, degree, gamma, coef0,
        Workspace{workspace, workspace_bytes}, stream);
}

extern "C" int plssvm_gram_matvec_rect_tc_bf16(
    const void* P, const void* S, const float* sq_p, const float* sq_s,
    const float* a_s, float* out, int64_t n_p, int64_t n_s, int64_t d_pad,
    int kind, int degree, float gamma, float coef0, void* workspace,
    int64_t* workspace_bytes, void* stream) {
    return tc_rect<Bf16Tier>(P, S, sq_p, sq_s, a_s, out, n_p, n_s, d_pad, 1,
                             kind, degree, gamma, coef0,
        Workspace{workspace, workspace_bytes}, stream);
}

// Kernel B at "highest" on the same tile in three TF32 passes: P and S the
// split stacks (2, n_p, d_pad) and (2, n_s, d_pad).
extern "C" int plssvm_gram_matvec_rect_tc_tf32x3(
    const void* P, const void* S, const float* sq_p, const float* sq_s,
    const float* a_s, float* out, int64_t n_p, int64_t n_s, int64_t d_pad,
    int kind, int degree, float gamma, float coef0, void* workspace,
    int64_t* workspace_bytes, void* stream) {
    return tc_rect<Tf32x3Tier>(P, S, sq_p, sq_s, a_s, out, n_p, n_s, d_pad, 1,
                               kind, degree, gamma, coef0,
        Workspace{workspace, workspace_bytes}, stream);
}

// The fixed-order sums' counter (fixed_sum.cuh) and the reduction alone:
// out[e] += ws[e] + ws[stride + e] + ... for e < n, slots in order, on
// the stream (ops/gram_matvec.py fixed_sum: chip_smoke.py's check and
// timing of the kernel).
std::atomic<int64_t>& fixed_sum_launch_count() {
    static std::atomic<int64_t> count{0};
    return count;
}

// The launches since the library was loaded or the last reset; reset 1
// sets the count to 0 after reading it.
extern "C" int64_t plssvm_fixed_sum_launches(int reset) {
    return reset ? fixed_sum_launch_count().exchange(0) : fixed_sum_launch_count().load();
}

extern "C" int plssvm_fixed_sum_f32(const float* ws, int64_t slots, int64_t stride,
                                    int64_t n, float* out, void* stream) {
    return fixed_sum(ws, slots, stride, n, out, static_cast<cudaStream_t>(stream));
}

extern "C" int plssvm_fixed_sum_f64(const double* ws, int64_t slots, int64_t stride,
                                    int64_t n, double* out, void* stream) {
    return fixed_sum(ws, slots, stride, n, out, static_cast<cudaStream_t>(stream));
}

extern "C" const char* plssvm_cuda_error_string(int error) {
    return cudaGetErrorString(static_cast<cudaError_t>(error));
}
