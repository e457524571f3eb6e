// The pieces the kernels share (gram_matvec.cu: kernels A and B;
// gram_matmat.cu: kernels C and D; distance.cu: kernels E-H; banded.cu:
// kernel I; gram_tc.cuh, the tensor-core tiles of A-D, takes the kernel
// functions and the class chunk): the
// kernel-function epilogues, the register tile with its shared-memory
// feature-chunk loader and its pair operation (the Gram product, or the
// laplacian / chi-squared distance term), the half-warp reduction, the
// upper-triangle tile walk, and the class loops of the block matmats.
//
// Everything here lives in an unnamed namespace: each .cu file that
// includes it gets its own copy, and the library's only exported symbols
// are the extern "C" entry points of the .cu files.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kPolynomial = 1;  // KernelFunctionType values (parameter.py)
constexpr int kRbf = 2;
constexpr int kSigmoid = 3;
constexpr int kLaplacian = 4;
constexpr int kChiSquared = 5;

constexpr int kThreads = 16;  // blocks of kThreads x kThreads threads
constexpr int kChunk = 16;    // features staged in shared memory per step

// Tile edge BM: R = BM / kThreads accumulators per thread and axis.
template <typename T>
struct TileEdge;
template <>
struct TileEdge<float> {
    static constexpr int value = 128;  // 8 x 8 accumulators
};
template <>
struct TileEdge<double> {
    static constexpr int value = 64;  // 4 x 4 accumulators
};

__device__ __forceinline__ float dev_exp(float x) { return expf(x); }
__device__ __forceinline__ double dev_exp(double x) { return exp(x); }
__device__ __forceinline__ float dev_tanh(float x) { return tanhf(x); }
__device__ __forceinline__ double dev_tanh(double x) { return tanh(x); }
__device__ __forceinline__ float dev_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double dev_abs(double x) { return fabs(x); }

// base**degree by repeated squaring (kernel_functions._integer_power).
template <typename T>
__device__ __forceinline__ T int_power(T base, int degree) {
    const bool invert = degree < 0;
    unsigned int n = invert ? static_cast<unsigned int>(-degree)
                            : static_cast<unsigned int>(degree);
    T result = T(1);
    T acc = base;
    while (n != 0u) {
        if (n & 1u) {
            result *= acc;
        }
        acc *= acc;
        n >>= 1;
    }
    return invert ? T(1) / result : result;
}

template <typename T, int KIND>
__device__ __forceinline__ T apply_kernel(T g, T sq_i, T sq_j, T gamma,
                                          T coef0, int degree) {
    if constexpr (KIND == kPolynomial) {
        return int_power(gamma * g + coef0, degree);
    } else if constexpr (KIND == kRbf) {
        return dev_exp(-gamma * (sq_i + sq_j - T(2) * g));
    } else {
        return dev_tanh(gamma * g + coef0);
    }
}

// The pair operation the register tile folds in, one feature at a time,
// and how gram_tile runs it on T: kUnroll<T>, how far it unrolls its loop
// over a staged feature chunk; kChunkSums<T>, whether it sums each chunk
// into a partial of its own before adding that to the accumulator; and
// kEdge<T>, the tile edge of the distance kernels (TileDefaults: the full
// unroll, no chunk sums, TileEdge).
struct TileDefaults {
    template <typename T>
    static constexpr int kUnroll = kChunk;
    template <typename T>
    static constexpr bool kChunkSums = false;
    template <typename T>
    static constexpr int kEdge = TileEdge<T>::value;
};
struct GramProduct : TileDefaults {  // x . y: one FMA
    template <typename T>
    __device__ __forceinline__ static void step(T& acc, T x, T y) {
        acc += x * y;
    }
};
struct L1Distance : TileDefaults {  // |x - y|: a subtract and an add with |.|
    template <typename T>
    __device__ __forceinline__ static void step(T& acc, T x, T y) {
        acc += dev_abs(x - y);
    }
};

// 1 / x on the special-function unit: one MUFU.RCP, about 1 ulp, no slow
// path.  .ftz flushes a subnormal x to 0 (and 1 / 0 = inf): the caller
// keeps x >= 1e-30.
__device__ __forceinline__ float sfu_reciprocal(float x) {
    float r;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
    return r;
}

// (x - y)^2 / (x + y), and 0 where x + y == 0.
//
// float, as the TPU kernel computes it (pallas_distance.py
// _distance_partial): the approximate reciprocal of den + 1e-30, so that
// 0/0 and a subnormal den give diff^2 * r = 0 with no branch (for den > 0
// the 1e-30 is below float resolution unless den < 1e-23, where the term
// is below 1e-23 itself).  Without the TPU kernel's Newton step: MUFU.RCP
// is about 1 ulp, and the step changed no worst per-entry error while it
// cost 16 % (below).  Per pair and feature: 1 SFU reciprocal, 2 adds, the
// bias add, a multiply and an FMA; the SFU (16 results per clock and SM
// against 128 FP32 lanes) bounds the loop.  The chunk loop unrolls fully.
// Each 16-feature chunk is summed into a partial of its own: summed one
// feature after another over d = 784, the rounding comes to 6x the plain
// version's per-entry error (a tree sum), per chunk to 2x.  The partials
// need 64 more registers at the 128-row tile (one block per SM), so float
// chi-squared takes a 64-row tile, where they cost 4 %.
//
// double keeps the IEEE divide, one feature per loop trip (each divide
// inlines ~15 instructions and a slow-path branch; unrolled they
// overflowed the instruction cache), summed one feature after another, on
// the 64-row double tile.
//
// The variants measured (recorded in PERF.md): kernel G (float, C = 10) on
// an H100 80GB HBM3 at 700 W, histogram rows, ms at m = 16384, d = 256 / at
// m = 59999, d = 784 (share of the SFU bound 8.206 / 336.997 ms),
// registers:
//
//   IEEE divide, edge 128, unroll 1 (before)   50.656 / 1451.921  (0.232)  124
//   edge 128, chunk sums, unroll 1             18.608 /  747.343  (0.451)  168
//                                   unroll 2   17.220 /  690.126  (0.488)  176
//                                   unroll 4   17.614 /  707.812  (0.476)  176
//                                   unroll 8   17.719 /  715.354  (0.471)  179
//                                   unroll 16  12.279 /  501.780  (0.672)  245
//   edge 128, no chunk sums, unroll 4           9.979 /  391.124  (0.862)  124
//   edge 64, chunk sums, unroll 1              11.265 /  435.529  (0.774)   56
//                                   unroll 2   11.102 /  422.648  (0.797)   55
//                                   unroll 4   10.934 /  415.972  (0.810)   55
//                                   unroll 8   10.855 /  420.050  (0.802)   58
//                                   unroll 16  10.826 /  415.706  (0.811)   59  kept
//   edge 64, unroll 4, Newton step             12.492 /  482.540  (0.698)   57
//   edge 64, unroll 4, no chunk sums           10.258 /  398.986  (0.845)   48
//
// Per entry of K (d = 3, 203, 784; zero-rich, scaled and subnormal rows)
// the worst error is 2.0x the float plain version's own with chunk sums,
// Newton step or not, and 6.1x without them, as with the IEEE divide.
struct ChiSquaredDistance {
    template <typename T>
    static constexpr int kUnroll = std::is_same_v<T, float> ? kChunk : 1;
    template <typename T>
    static constexpr bool kChunkSums = std::is_same_v<T, float>;
    template <typename T>
    static constexpr int kEdge =
        std::is_same_v<T, float> ? 64 : TileEdge<T>::value;

    __device__ __forceinline__ static void step(float& acc, float x, float y) {
        const float den = (x + y) + 1e-30f;
        const float diff = x - y;
        acc = fmaf(diff, diff * sfu_reciprocal(den), acc);
    }
    // the select keeps 0/0 out, so the zero-loaded feature tail adds
    // nothing
    __device__ __forceinline__ static void step(double& acc, double x,
                                                double y) {
        const double den = x + y;
        const double diff = x - y;
        acc += den != 0.0 ? diff * diff / den : 0.0;
    }
};

template <int KIND>
struct DistanceOp;
template <>
struct DistanceOp<kLaplacian> {
    using type = L1Distance;
};
template <>
struct DistanceOp<kChiSquared> {
    using type = ChiSquaredDistance;
};

// Tile edge of the distance kernel KIND on T: its pair operation's kEdge.
template <typename T, int KIND>
constexpr int kDistanceEdge = DistanceOp<KIND>::type::template kEdge<T>;

template <typename T, int BM>
struct Staging {
    // transposed feature chunks; the +1 spreads the stores over the banks
    T x[kChunk][BM + 1];
    T y[kChunk][BM + 1];
};

// acc[a][b] += op(x, y) over the kChunk features staged in s, x the rows
// ty + kThreads a and y the rows tx + kThreads b of the tile; the loop over
// the features unrolled by kUnroll.
template <typename T, int BM, typename Op, int kUnroll>
__device__ __forceinline__ void chunk_pass(
    const Staging<T, BM>& s, T (&acc)[BM / kThreads][BM / kThreads]) {
    constexpr int R = BM / kThreads;
    const int tx = threadIdx.x;
    const int ty = threadIdx.y;
#pragma unroll (kUnroll)
    for (int kk = 0; kk < kChunk; ++kk) {
        T xa[R];
        T yb[R];
#pragma unroll
        for (int a = 0; a < R; ++a) {
            xa[a] = s.x[kk][ty + kThreads * a];
        }
#pragma unroll
        for (int b = 0; b < R; ++b) {
            yb[b] = s.y[kk][tx + kThreads * b];
        }
#pragma unroll
        for (int a = 0; a < R; ++a) {
#pragma unroll
            for (int b = 0; b < R; ++b) {
                Op::step(acc[a][b], xa[a], yb[b]);
            }
        }
    }
}

// acc[a][b] = sum_k op(X[row0 + ty + kThreads a, k], Y[col0 + tx + kThreads b, k])
// over all d features, op the Gram product by default; rows past mx / my
// and features past d load as 0.  X and Y are row-major (rows, d) or, with
// kFeatureMajor, transposed: (d, mx) and (d, my), a feature's values of all
// rows side by side.
template <typename T, int BM, typename Op = GramProduct,
          bool kFeatureMajor = false>
__device__ __forceinline__ void gram_tile(
    const T* __restrict__ X, const T* __restrict__ Y, int64_t mx,
    int64_t my, int64_t d, int64_t row0, int64_t col0, Staging<T, BM>& s,
    T (&acc)[BM / kThreads][BM / kThreads]) {
    constexpr int R = BM / kThreads;
    const int tx = threadIdx.x;
    const int ty = threadIdx.y;
    const int tid = ty * kThreads + tx;
#pragma unroll
    for (int a = 0; a < R; ++a) {
#pragma unroll
        for (int b = 0; b < R; ++b) {
            acc[a][b] = T(0);
        }
    }
    for (int64_t k0 = 0; k0 < d; k0 += kChunk) {
        for (int e = tid; e < BM * kChunk; e += kThreads * kThreads) {
            if constexpr (kFeatureMajor) {
                // neighbouring threads read neighbouring rows of one feature
                const int r = e % BM;
                const int kk = e / BM;
                const int64_t k = k0 + kk;
                const int64_t gx = row0 + r;
                const int64_t gy = col0 + r;
                s.x[kk][r] = (gx < mx && k < d) ? X[k * mx + gx] : T(0);
                s.y[kk][r] = (gy < my && k < d) ? Y[k * my + gy] : T(0);
            } else {
                // neighbouring threads read neighbouring features of one row
                const int r = e / kChunk;
                const int kk = e % kChunk;
                const int64_t k = k0 + kk;
                const int64_t gx = row0 + r;
                const int64_t gy = col0 + r;
                s.x[kk][r] = (gx < mx && k < d) ? X[gx * d + k] : T(0);
                s.y[kk][r] = (gy < my && k < d) ? Y[gy * d + k] : T(0);
            }
        }
        __syncthreads();
        if constexpr (Op::template kChunkSums<T>) {
            T part[R][R];
#pragma unroll
            for (int a = 0; a < R; ++a) {
#pragma unroll
                for (int b = 0; b < R; ++b) {
                    part[a][b] = T(0);
                }
            }
            chunk_pass<T, BM, Op, Op::template kUnroll<T>>(s, part);
#pragma unroll
            for (int a = 0; a < R; ++a) {
#pragma unroll
                for (int b = 0; b < R; ++b) {
                    acc[a][b] += part[a][b];
                }
            }
        } else {
            chunk_pass<T, BM, Op, Op::template kUnroll<T>>(s, acc);
        }
        __syncthreads();
    }
}

// In place: the Gram tile of gram_tile becomes the kernel tile
// k(x_row, y_col), with 0 outside the mx x my matrix.
template <typename T, int KIND, int BM>
__device__ __forceinline__ void kernel_tile(
    T (&acc)[BM / kThreads][BM / kThreads], const T* __restrict__ sq_x,
    const T* __restrict__ sq_y, int64_t mx, int64_t my, int64_t row0,
    int64_t col0, int degree, T gamma, T coef0) {
    constexpr int R = BM / kThreads;
    bool col_ok[R];
    T sq_c[R];
#pragma unroll
    for (int b = 0; b < R; ++b) {
        const int64_t c = col0 + threadIdx.x + kThreads * b;
        col_ok[b] = c < my;
        sq_c[b] = col_ok[b] ? sq_y[c] : T(0);
    }
#pragma unroll
    for (int a = 0; a < R; ++a) {
        const int64_t r = row0 + threadIdx.y + kThreads * a;
        const bool row_ok = r < mx;
        const T sq_r = row_ok ? sq_x[r] : T(0);
#pragma unroll
        for (int b = 0; b < R; ++b) {
            acc[a][b] = (row_ok && col_ok[b])
                ? apply_kernel<T, KIND>(acc[a][b], sq_r, sq_c[b], gamma,
                                        coef0, degree)
                : T(0);
        }
    }
}

// In place: the distance tile of gram_tile<T, BM, DistanceOp<...>> becomes
// the kernel tile exp(-gamma * dist), with 0 outside the mx x my matrix
// (rows past the matrix loaded as 0 give exp(-gamma |x|) != 0).
template <typename T, int BM>
__device__ __forceinline__ void distance_kernel_tile(
    T (&acc)[BM / kThreads][BM / kThreads], int64_t mx, int64_t my,
    int64_t row0, int64_t col0, T gamma) {
    constexpr int R = BM / kThreads;
#pragma unroll
    for (int a = 0; a < R; ++a) {
        const bool row_ok = row0 + threadIdx.y + kThreads * a < mx;
#pragma unroll
        for (int b = 0; b < R; ++b) {
            const bool ok = row_ok && col0 + threadIdx.x + kThreads * b < my;
            acc[a][b] = ok ? dev_exp(-gamma * acc[a][b]) : T(0);
        }
    }
}

// Sum over the 16 threads of a half warp (same ty, tx = 0..15).
template <typename T>
__device__ __forceinline__ T half_warp_sum(T value) {
#pragma unroll
    for (int offset = kThreads / 2; offset > 0; offset /= 2) {
        value += __shfl_xor_sync(0xffffffffu, value, offset);
    }
    return value;
}

// Linear block index p -> upper-triangle tile (it, jt), it <= jt.
__device__ __forceinline__ void upper_triangle_tile(int64_t p, int64_t& it,
                                                    int64_t& jt) {
    jt = static_cast<int64_t>(
        (sqrt(8.0 * static_cast<double>(p) + 1.0) - 1.0) * 0.5);
    while (jt * (jt + 1) / 2 > p) {
        --jt;
    }
    while ((jt + 1) * (jt + 2) / 2 <= p) {
        ++jt;
    }
    it = p - jt * (jt + 1) / 2;
}

// classes whose V rows are staged in shared memory at once
constexpr int kClassChunk = 8;

// dst[cc][r] = V[(r0 + r) * C + c0 + cc] for r < BM, cc < cn; rows past m
// load 0.  Neighbouring threads read neighbouring classes of one row.
template <typename T, int BM>
__device__ __forceinline__ void stage_classes(const T* __restrict__ V,
                                              int64_t m, int64_t C,
                                              int64_t r0, int64_t c0, int cn,
                                              T (*dst)[BM + 1]) {
    const int tid = threadIdx.y * kThreads + threadIdx.x;
    for (int e = tid; e < BM * cn; e += kThreads * kThreads) {
        const int r = e / cn;
        const int cc = e % cn;
        const int64_t g = r0 + r;
        dst[cc][r] = g < m ? V[g * C + c0 + cc] : T(0);
    }
}

// The class loop of the symmetric block matmats (kernels C and G): with the
// kernel tile kv in registers, out[r, c] += sum_j kv[r][j] V[j, c] for the
// tile's rows and, off the diagonal, out[j, c] += sum_r kv[r][j] V[r, c] for
// its columns, for every class c.  V and out are (m, C) row-major; the V
// rows of both tiles are staged kClassChunk classes at a time in v_cols /
// v_rows, the column partials are reduced through col_part.
template <typename T, int BM>
__device__ __forceinline__ void sym_class_loop(
    const T (&kv)[BM / kThreads][BM / kThreads], const T* __restrict__ V,
    T* __restrict__ out, int64_t m, int64_t C, int64_t row0, int64_t col0,
    bool off_diagonal, T (*v_cols)[BM + 1], T (*v_rows)[BM + 1],
    T (*col_part)[BM]) {
    constexpr int R = BM / kThreads;
    const int tx = threadIdx.x;
    const int ty = threadIdx.y;
    const int tid = ty * kThreads + tx;
    for (int64_t c0 = 0; c0 < C; c0 += kClassChunk) {
        const int cn = static_cast<int>(
            C - c0 < kClassChunk ? C - c0 : kClassChunk);
        __syncthreads();  // the previous chunk's readers are done
        stage_classes<T, BM>(V, m, C, col0, c0, cn, v_cols);
        if (off_diagonal) {
            stage_classes<T, BM>(V, m, C, row0, c0, cn, v_rows);
        }
        __syncthreads();
        for (int cc = 0; cc < cn; ++cc) {
            const int64_t c = c0 + cc;
            T vc[R];
#pragma unroll
            for (int b = 0; b < R; ++b) {
                vc[b] = v_cols[cc][tx + kThreads * b];
            }
#pragma unroll
            for (int a = 0; a < R; ++a) {
                T row_sum = T(0);
#pragma unroll
                for (int b = 0; b < R; ++b) {
                    row_sum += kv[a][b] * vc[b];
                }
                const T total = half_warp_sum(row_sum);
                const int64_t r = row0 + ty + kThreads * a;
                if (tx == 0 && r < m) {
                    atomicAdd(&out[r * C + c], total);
                }
            }
            if (off_diagonal) {
                T vr[R];
#pragma unroll
                for (int a = 0; a < R; ++a) {
                    vr[a] = v_rows[cc][ty + kThreads * a];
                }
#pragma unroll
                for (int b = 0; b < R; ++b) {
                    T col_sum = T(0);
#pragma unroll
                    for (int a = 0; a < R; ++a) {
                        col_sum += kv[a][b] * vr[a];
                    }
                    col_part[ty][tx + kThreads * b] = col_sum;
                }
                __syncthreads();
                for (int j = tid; j < BM; j += kThreads * kThreads) {
                    T total = T(0);
#pragma unroll
                    for (int y = 0; y < kThreads; ++y) {
                        total += col_part[y][j];
                    }
                    if (col0 + j < m) {
                        atomicAdd(&out[(col0 + j) * C + c], total);
                    }
                }
                __syncthreads();  // col_part is written again next class
            }
        }
    }
}

// The class loop of the rectangular block matmats (kernels D and H):
// out[r, c] += sum_j kv[r][j] A[j, c] for the point tile's rows, A (n_s, C)
// staged kClassChunk classes at a time in a_cols.
template <typename T, int BM>
__device__ __forceinline__ void rect_class_loop(
    const T (&kv)[BM / kThreads][BM / kThreads], const T* __restrict__ A,
    T* __restrict__ out, int64_t n_p, int64_t n_s, int64_t C, int64_t row0,
    int64_t col0, T (*a_cols)[BM + 1]) {
    constexpr int R = BM / kThreads;
    const int tx = threadIdx.x;
    const int ty = threadIdx.y;
    for (int64_t c0 = 0; c0 < C; c0 += kClassChunk) {
        const int cn = static_cast<int>(
            C - c0 < kClassChunk ? C - c0 : kClassChunk);
        __syncthreads();  // the previous chunk's readers are done
        stage_classes<T, BM>(A, n_s, C, col0, c0, cn, a_cols);
        __syncthreads();
        for (int cc = 0; cc < cn; ++cc) {
            const int64_t c = c0 + cc;
            T ac[R];
#pragma unroll
            for (int b = 0; b < R; ++b) {
                ac[b] = a_cols[cc][tx + kThreads * b];
            }
#pragma unroll
            for (int a = 0; a < R; ++a) {
                T row_sum = T(0);
#pragma unroll
                for (int b = 0; b < R; ++b) {
                    row_sum += kv[a][b] * ac[b];
                }
                const T total = half_warp_sum(row_sum);
                const int64_t r = row0 + ty + kThreads * a;
                if (tx == 0 && r < n_p) {
                    atomicAdd(&out[r * C + c], total);
                }
            }
        }
    }
}

}  // namespace
