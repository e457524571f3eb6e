// Distance-kernel (laplacian, chi-squared) matvecs and block matmats for
// LS-SVM training and predict, written by hand for NVIDIA Hopper (sm_90a).
// Bound to PyTorch through a plain C interface and ctypes
// (plssvm_tpu_torch/ops/distance.py); built by ops/_build.py.
//
// laplacian   k(u, v) = exp(-gamma * sum_k |u_k - v_k|)
// chi-squared k(u, v) = exp(-gamma * sum_k (u_k - v_k)^2 / (u_k + v_k)),
//             a term taken as 0 where u_k + v_k == 0
//
// Kernel E, distance_matvec_sym: out = K(X, X) @ v, every CG iteration.
//   Replaces the Pallas kernel plssvm_tpu/ops/pallas_distance.py
//   distance_matvec_pallas_dual (body _distance_kernel_dual) with
//   symmetric=True, and the composition distance_matvec_pallas_big around
//   it.  Kernel A's walk: a 1-D grid over the upper-triangle BM x BM tiles,
//   the register tile fed from shared-memory feature chunks, the epilogue
//   fused into the row sums (half-warp shuffle, one slot per row and
//   partner tile) and, off the diagonal, the column sums (shared memory,
//   one slot per column and partner tile), summed in a fixed order by
//   fixed_sum.cuh.
// Kernel F, distance_matvec_rect: out = K(P, S) @ a, binary predict.  The
//   symmetric=False use of distance_matvec_pallas_dual; kernel B's 2-D grid
//   (point tiles x support-vector tiles), the row sums a slot per SV tile.
// Kernel G, distance_matmat_sym: out = K(X, X) @ V for V (m, C) row-major,
//   every block-CG iteration of a one-vs-all fit.  Replaces
//   distance_matmat_pallas_dual (body _distance_kernel_matmat_dual) with
//   symmetric=True and its composition distance_matmat_pallas_big; kernel
//   C's walk and class loop.
// Kernel H, distance_matmat_rect: out = K(P, S) @ A for A (n_s, C),
//   multiclass and one-vs-one predict; the symmetric=False use of
//   distance_matmat_pallas_dual, kernel D's grid and class loop.
//
// All four are kernels A-D with another pair operation in the shared tile
// (gram_tile.cuh): |x - y| or (x - y)^2 / (x + y) in place of x * y, and
// exp(-gamma * acc) as the epilogue.  Sizes are 64-bit, so one launch
// covers any m, d and C >= 1; ragged rows and features are masked in the
// kernel, nothing is padded.  Not carried over from the TPU: the 8-row
// group walk and feature blocks sized for VMEM, the 128-row padding, the
// class-major layout padded to 8, the resident column accumulator (the
// slots of fixed_sum.cuh replace it), the chunk compositions and their op cap (a TPU watchdog
// limit).
//
// What bounds them: the pair operation on the CUDA cores, BM^2 * d pair
// evaluations per tile, with no tensor-core formulation (the distances do
// not factor through a matrix product).  Laplacian costs two FP32
// instructions per pair and feature (a subtract, an add with the |.|
// modifier) where the Gram tile costs one FFMA; on an H100 kernel E takes
// 1.4x kernel A's time.  Chi-squared in float costs one reciprocal on the
// special-function unit (MUFU.RCP: 16 per clock per SM against 128 FP32
// lanes) and five FP32 instructions, so the SFU bounds it.  The design
// keeps the SFU busy: the TPU kernel's approximate reciprocal now has its
// counterpart (of den + 1e-30, without the Newton step: MUFU.RCP is ~1
// ulp), no branch is left in the loop, and with the slow-path code gone
// the chunk loop unrolls fully again.  Each 16-feature chunk is summed into
// a partial of its own, which holds each entry of K within 2x the plain
// version's error, and those partials fit the registers only in a 64-row
// tile: at 59999 x 784 with 10 classes kernel G runs at 0.81 of its SFU
// bound (0.23 with the IEEE divide).  Chi-squared in double runs on the
// FP64 pipe (17 T instructions/s): its quotient takes the reciprocal's
// seed on the SFU, two Newton steps and one correction, 7 FP64
// instructions beside the subtract, add, square and accumulating add, on
// chunks whose values lie in the range where that sequence is the IEEE
// quotient; a chunk with a value outside it takes the IEEE divide (both
// in the same kernel).  gram_tile.cuh ChiSquaredDistance sets the unroll,
// the chunk sums, the edge and the guard per type, and holds the variants
// measured.
// The register tile (R x R accumulators per thread) amortises the
// shared-memory loads as in kernel A.
//
// Numerics: no fast-math.  Chi-squared in float takes the approximate
// reciprocal (per entry of K within 2x the plain version's error, which
// divides exactly); in double each term is the IEEE-rounded quotient, as
// the plain version's divide gives it, on every chunk.  Every sum across
// blocks is taken in an order fixed by the shapes (fixed_sum.cuh), so two
// launches on the same input give equal bits.

#include <type_traits>

#include "gram_tile.cuh"

namespace {

template <typename T, int KIND>
__global__ void __launch_bounds__(kThreads * kThreads)
    distance_matvec_sym_kernel(const T* __restrict__ X,
                               const T* __restrict__ v, T* __restrict__ ws,
                               SymPass pass, int64_t m, int64_t d, T gamma) {
    constexpr int BM = kDistanceEdge<T, KIND>;
    constexpr int R = BM / kThreads;
    __shared__ Staging<T, BM> staging;
    __shared__ T col_part[kThreads][BM];

    int64_t it, jt;
    upper_triangle_tile(pass.first_block() + blockIdx.x, it, jt);
    const int64_t row0 = it * BM;
    const int64_t col0 = jt * BM;

    T acc[R][R];
    gram_tile<T, BM, typename DistanceOp<KIND>::type>(X, X, m, m, d, row0,
                                                      col0, staging, acc);

    const int tx = threadIdx.x;
    const int ty = threadIdx.y;
    bool row_ok[R];
    bool col_ok[R];
    T v_r[R], v_c[R];
#pragma unroll
    for (int a = 0; a < R; ++a) {
        const int64_t r = row0 + ty + kThreads * a;
        row_ok[a] = r < m;
        v_r[a] = row_ok[a] ? v[r] : T(0);
    }
#pragma unroll
    for (int b = 0; b < R; ++b) {
        const int64_t c = col0 + tx + kThreads * b;
        col_ok[b] = c < m;
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
                ? dev_exp(-gamma * acc[a][b]) : T(0);
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

// Rows [0, n_p) of P are a band of the walk (fixed_sum.cuh run_rows): the
// row sums of point tile i against SV tile q go to ws[q ws_rows + r].
template <typename T, int KIND>
__global__ void __launch_bounds__(kThreads * kThreads)
    distance_matvec_rect_kernel(const T* __restrict__ P,
                                const T* __restrict__ S,
                                const T* __restrict__ a_s,
                                T* __restrict__ ws, int64_t ws_rows,
                                int64_t n_p, int64_t n_s, int64_t d,
                                int64_t n_stiles, T gamma) {
    constexpr int BM = kDistanceEdge<T, KIND>;
    constexpr int R = BM / kThreads;
    __shared__ Staging<T, BM> staging;

    // consecutive blocks share a point tile and walk the SV tiles
    const int64_t p = blockIdx.x;
    const int64_t row0 = (p / n_stiles) * BM;
    const int64_t col0 = (p % n_stiles) * BM;
    T* slot = ws + (p % n_stiles) * ws_rows;

    T acc[R][R];
    gram_tile<T, BM, typename DistanceOp<KIND>::type>(P, S, n_p, n_s, d, row0,
                                                      col0, staging, acc);

    const int tx = threadIdx.x;
    const int ty = threadIdx.y;
    bool col_ok[R];
    T w_c[R];
#pragma unroll
    for (int b = 0; b < R; ++b) {
        const int64_t c = col0 + tx + kThreads * b;
        col_ok[b] = c < n_s;
        w_c[b] = col_ok[b] ? a_s[c] : T(0);
    }
#pragma unroll
    for (int a = 0; a < R; ++a) {
        const bool row_ok = row0 + ty + kThreads * a < n_p;
        T row_sum = T(0);
#pragma unroll
        for (int b = 0; b < R; ++b) {
            const T kval = (row_ok && col_ok[b])
                ? dev_exp(-gamma * acc[a][b]) : T(0);
            row_sum += kval * w_c[b];
        }
        const T total = half_warp_sum(row_sum);
        if (tx == 0 && row_ok) {
            slot[row0 + ty + kThreads * a] = total;
        }
    }
}

template <typename T, int KIND>
__global__ void __launch_bounds__(kThreads * kThreads)
    distance_matmat_sym_kernel(const T* __restrict__ X,
                               const T* __restrict__ V, T* __restrict__ ws,
                               SymPass pass, int64_t m, int64_t d, int64_t C,
                               T gamma) {
    constexpr int BM = kDistanceEdge<T, KIND>;
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
    gram_tile<T, BM, typename DistanceOp<KIND>::type>(X, X, m, m, d, row0,
                                                      col0, staging, kv);
    distance_kernel_tile<T, BM>(kv, m, m, row0, col0, gamma);
    sym_class_loop<T, BM>(kv, V, ws, pass, m, C, it, jt, v_cols, v_rows,
                          col_part);
}

template <typename T, int KIND>
__global__ void __launch_bounds__(kThreads * kThreads)
    distance_matmat_rect_kernel(const T* __restrict__ P,
                                const T* __restrict__ S,
                                const T* __restrict__ A, T* __restrict__ ws,
                                int64_t ws_rows, int64_t n_p, int64_t n_s,
                                int64_t d, int64_t C, int64_t n_stiles,
                                T gamma) {
    constexpr int BM = kDistanceEdge<T, KIND>;
    constexpr int R = BM / kThreads;
    __shared__ Staging<T, BM> staging;
    __shared__ T a_cols[kClassChunk][BM + 1];  // A rows of the SV tile

    const int64_t p = blockIdx.x;
    const int64_t row0 = (p / n_stiles) * BM;
    const int64_t col0 = (p % n_stiles) * BM;

    T kv[R][R];
    gram_tile<T, BM, typename DistanceOp<KIND>::type>(P, S, n_p, n_s, d, row0,
                                                      col0, staging, kv);
    distance_kernel_tile<T, BM>(kv, n_p, n_s, row0, col0, gamma);
    rect_class_loop<T, BM>(kv, A, ws, ws_rows, n_p, n_s, C, row0, col0, a_cols);
}

// launch(std::integral_constant<int, KIND>) for the runtime kind.
template <typename Launch>
int by_kind(int kind, Launch&& launch) {
    switch (kind) {
        case kLaplacian:
            return launch(std::integral_constant<int, kLaplacian>{});
        case kChiSquared:
            return launch(std::integral_constant<int, kChiSquared>{});
        default:
            return cudaErrorInvalidValue;
    }
}

// Kernels E (``matvec``, C = 1) and G: the upper triangle in the passes of
// sym_plan.
template <typename T, int KIND>
cudaError_t launch_sym(const T* X, const T* V, T* out, int64_t m, int64_t d,
                       int64_t C, bool matvec, T gamma,
                       const Workspace& workspace, cudaStream_t stream) {
    constexpr int BM = kDistanceEdge<T, KIND>;
    if (m <= 0 || d < 0 || C <= 0) {
        return cudaErrorInvalidValue;
    }
    return run_sym<T>(workspace, m, BM, 1, C, out, stream,
                      [&](const SymPass& pass, T* ws) {
        const unsigned int blocks = static_cast<unsigned int>(pass.blocks());
        if (matvec) {
            distance_matvec_sym_kernel<T, KIND>
                <<<blocks, dim3(kThreads, kThreads), 0, stream>>>(
                    X, V, ws, pass, m, d, gamma);
        } else {
            distance_matmat_sym_kernel<T, KIND>
                <<<blocks, dim3(kThreads, kThreads), 0, stream>>>(
                    X, V, ws, pass, m, d, C, gamma);
        }
        return cudaGetLastError();
    });
}

// Kernels F (``matvec``, C = 1) and H: point tiles x SV tiles in the row
// bands of row_plan.
template <typename T, int KIND>
cudaError_t launch_rect(const T* P, const T* S, const T* A, T* out,
                        int64_t n_p, int64_t n_s, int64_t d, int64_t C,
                        bool matvec, T gamma, const Workspace& workspace,
                        cudaStream_t stream) {
    constexpr int BM = kDistanceEdge<T, KIND>;
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
            const dim3 grid(static_cast<unsigned int>(blocks));
            if (matvec) {
                distance_matvec_rect_kernel<T, KIND>
                    <<<grid, dim3(kThreads, kThreads), 0, stream>>>(
                        P + row0 * d, S, A, ws, ws_rows, rows, n_s, d,
                        n_stiles, gamma);
            } else {
                distance_matmat_rect_kernel<T, KIND>
                    <<<grid, dim3(kThreads, kThreads), 0, stream>>>(
                        P + row0 * d, S, A, ws, ws_rows, rows, n_s, d, C,
                        n_stiles, gamma);
            }
            return cudaGetLastError();
        });
}

template <typename T>
int sym(const T* X, const T* V, T* out, int64_t m, int64_t d, int64_t C,
        bool matvec, int kind, T gamma, void* workspace,
        int64_t* workspace_bytes, void* stream) {
    return by_kind(kind, [&](auto k) {
        return static_cast<int>(launch_sym<T, decltype(k)::value>(
            X, V, out, m, d, C, matvec, gamma, Workspace{workspace, workspace_bytes},
            static_cast<cudaStream_t>(stream)));
    });
}

template <typename T>
int rect(const T* P, const T* S, const T* A, T* out, int64_t n_p, int64_t n_s,
         int64_t d, int64_t C, bool matvec, int kind, T gamma, void* workspace,
         int64_t* workspace_bytes, void* stream) {
    return by_kind(kind, [&](auto k) {
        return static_cast<int>(launch_rect<T, decltype(k)::value>(
            P, S, A, out, n_p, n_s, d, C, matvec, gamma,
            Workspace{workspace, workspace_bytes},
            static_cast<cudaStream_t>(stream)));
    });
}

}  // namespace

// The C interface: every entry point returns the cudaError_t of its
// launches (0 on success).  kind is KernelFunctionType's value (4
// laplacian, 5 chi-squared); out ((rows,) or (rows, C) row-major) must hold
// zeros: the sums are added to it.  workspace holds *workspace_bytes bytes;
// a null workspace asks for the bytes the call needs, written to
// *workspace_bytes, and launches nothing (fixed_sum.cuh).

extern "C" int plssvm_distance_matvec_sym_f32(const float* X, const float* v,
                                              float* out, int64_t m,
                                              int64_t d, int kind,
                                              float gamma, void* workspace,
                                              int64_t* workspace_bytes,
                                              void* stream) {
    return sym<float>(X, v, out, m, d, 1, true, kind, gamma, workspace,
                      workspace_bytes, stream);
}

extern "C" int plssvm_distance_matvec_sym_f64(const double* X,
                                              const double* v, double* out,
                                              int64_t m, int64_t d, int kind,
                                              double gamma, void* workspace,
                                              int64_t* workspace_bytes,
                                              void* stream) {
    return sym<double>(X, v, out, m, d, 1, true, kind, gamma, workspace,
                       workspace_bytes, stream);
}

extern "C" int plssvm_distance_matvec_rect_f32(const float* P, const float* S,
                                               const float* a_s, float* out,
                                               int64_t n_p, int64_t n_s,
                                               int64_t d, int kind,
                                               float gamma, void* workspace,
                                               int64_t* workspace_bytes,
                                               void* stream) {
    return rect<float>(P, S, a_s, out, n_p, n_s, d, 1, true, kind, gamma,
                       workspace, workspace_bytes, stream);
}

extern "C" int plssvm_distance_matvec_rect_f64(
    const double* P, const double* S, const double* a_s, double* out,
    int64_t n_p, int64_t n_s, int64_t d, int kind, double gamma,
    void* workspace, int64_t* workspace_bytes, void* stream) {
    return rect<double>(P, S, a_s, out, n_p, n_s, d, 1, true, kind, gamma,
                        workspace, workspace_bytes, stream);
}

extern "C" int plssvm_distance_matmat_sym_f32(const float* X, const float* V,
                                              float* out, int64_t m,
                                              int64_t d, int64_t C, int kind,
                                              float gamma, void* workspace,
                                              int64_t* workspace_bytes,
                                              void* stream) {
    return sym<float>(X, V, out, m, d, C, false, kind, gamma, workspace,
                      workspace_bytes, stream);
}

extern "C" int plssvm_distance_matmat_sym_f64(const double* X,
                                              const double* V, double* out,
                                              int64_t m, int64_t d, int64_t C,
                                              int kind, double gamma,
                                              void* workspace,
                                              int64_t* workspace_bytes,
                                              void* stream) {
    return sym<double>(X, V, out, m, d, C, false, kind, gamma, workspace,
                       workspace_bytes, stream);
}

extern "C" int plssvm_distance_matmat_rect_f32(
    const float* P, const float* S, const float* A, float* out, int64_t n_p,
    int64_t n_s, int64_t d, int64_t C, int kind, float gamma, void* workspace,
    int64_t* workspace_bytes, void* stream) {
    return rect<float>(P, S, A, out, n_p, n_s, d, C, false, kind, gamma,
                       workspace, workspace_bytes, stream);
}

extern "C" int plssvm_distance_matmat_rect_f64(
    const double* P, const double* S, const double* A, double* out,
    int64_t n_p, int64_t n_s, int64_t d, int64_t C, int kind, double gamma,
    void* workspace, int64_t* workspace_bytes, void* stream) {
    return rect<double>(P, S, A, out, n_p, n_s, d, C, false, kind, gamma,
                        workspace, workspace_bytes, stream);
}
