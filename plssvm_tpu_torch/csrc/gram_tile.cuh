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

#include "fixed_sum.cuh"

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
// into a partial of its own before adding that to the accumulator, and
// kCompensated<T>, whether it adds those partials with a compensated
// (Kahan) sum; kEdge<T>, the tile edge of the distance kernels; and
// kGuarded<T>, whether its step holds only for values that pass its
// in_range test, a chunk holding any other value taking its Outside
// operation instead (TileDefaults: the full unroll, no chunk sums,
// TileEdge, no guard).
struct TileDefaults {
    template <typename T>
    static constexpr int kUnroll = kChunk;
    template <typename T>
    static constexpr bool kChunkSums = false;
    template <typename T>
    static constexpr bool kCompensated = false;
    template <typename T>
    static constexpr int kEdge = TileEdge<T>::value;
    template <typename T>
    static constexpr bool kGuarded = false;
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
// The seed of the float64 reciprocal: one MUFU.RCP64H on the high word,
// a relative error of about 2^-20, no slow path; a subnormal x flushes to 0.
__device__ __forceinline__ double sfu_reciprocal(double x) {
    double r;
    asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(x));
    return r;
}

// The range of the float64 chi-squared quotient without a divide: a staged
// value v passes when v == 0 or 2^kChi2F64MinExponent <= |v| <
// 2^(kChi2F64MaxExponent + 1), its binary exponent in [-433, 510].  Then
// every non-zero |v| is a multiple of g = 2^-485, and so are x + y and
// x - y: a non-zero |den| lies in [2^-485, 2^512), a non-zero diff^2 in
// [2^-970, 2^1024) (|diff| < 2^512 keeps it finite), 1 / den and the
// quotient are normal, and the exact remainder num - den * q is a multiple
// of 2^-1074, so a double: of 2^(e(num) - 105) >= 2^-1073 where |diff| >
// g, and where |diff| = g, den = 2x + g is rounded to an even significand.
// That is what the sequence in ChiSquaredDistance needs to be the IEEE
// quotient.  One binary exponent further out, diff^2 overflows (|x|, |y|
// near 2^511 of opposite sign) or the remainder of neighbours near 2^-434
// falls between multiples of 2^-1074; infinities, NaN and subnormals are
// out too.
constexpr int kChi2F64MinExponent = -433;
constexpr int kChi2F64MaxExponent = 510;

__device__ __forceinline__ bool chi2_f64_in_range(double v) {
    const unsigned long long bits =
        static_cast<unsigned long long>(__double_as_longlong(v));
    const int exponent = static_cast<int>((bits >> 52) & 0x7ffu) - 1023;
    return ((bits << 1) == 0ull)
        | (static_cast<unsigned int>(exponent - kChi2F64MinExponent) <=
           static_cast<unsigned int>(kChi2F64MaxExponent - kChi2F64MinExponent));
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
// double computes the IEEE-rounded quotient without a divide: the
// reciprocal's seed on the SFU (MUFU.RCP64H), two Newton steps of 2 DFMAs,
// the quotient num * r, its exact remainder and one correction, 7 FP64
// instructions beside the subtract, the add, the square and the
// accumulating add (and the select's DSETP), with no slow path and no
// branch, so the chunk loop unrolls.  That sequence is exact only within
// chi2_f64_in_range: after gram_tile stages a chunk, each thread tests the
// values it stored and __syncthreads_and makes one flag of the block; a
// chunk holding any other value takes Outside, the IEEE divide, one
// feature per loop trip (each divide inlines ~15 instructions and a
// slow-path branch; unrolled they overflowed the instruction cache).  Both
// passes sum each chunk into a partial of its own, on the 64-row double
// tile, and the partials are added with a compensated sum while every
// chunk so far took the divide-free pass: per entry of K against long
// double, on ops/entry_check.py's cases at d = 203 and 784 and 9999
// histogram rows of 200 bins, one feature after another comes to 2.4-6.4x
// the float64 plain version's worst error, chunk partials to 1.0-2.5x,
// compensated ones to 0.62-0.92x (after an out-of-range chunk, as plain
// partials: 1.04x and 1.83x on the "mixed" rows).  MUFU.RCP64H issues once
// per 12 FP64-pipe instructions (SASS), so the FP64 pipe, not the SFU,
// sets the pace.
//
// The variants measured in double: kernel G (C = 10) on an H100 80GB HBM3
// at 700 W, histogram rows at m = 16384, d = 256, ms (share of the 22.392
// ms bound, PAIR_FEATURE_COST_F64's 11), registers; chip_smoke.py's
// --compare-build timings run from each variant's tree:
//
//   IEEE divide, unroll 1, one feature after another (before)  75.3 (0.298)  98
//   divide-free, the guard in the staging loop, chunk partials added with
//     a compensated sum, unroll 16                            36.2 (0.618) 154
//                                                     unroll 8 36.1         154
//                                                     unroll 4 36.0 (0.622) 156
//                                                     unroll 2 36.4         168
//                                                     unroll 1 37.9         150
//     plain chunk partials, unroll 16                          34.0 (0.659) 126
//     one feature after another, unroll 16                     31.5 (0.710)  80
//   the guard in a loop of its own (the float kernels' code as before):
//     compensated, unroll 4                                    51.0 (0.439) 182
//       and an infinite sum ending it (an isfinite select)     51.4         182
//       and the running error clamped (fmin / fmax)            52.3         184
//     compensated while every chunk took the divide-free pass,
//       unroll 4                                               36.0 (0.622) 200  kept
//     plain chunk partials, unroll 4                           34.6 (0.647) 126
//     one feature after another, unroll 4                      31.9 (0.702)  92
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
    static constexpr int kUnroll = std::is_same_v<T, float> ? kChunk : 4;
    template <typename T>
    static constexpr bool kChunkSums = true;
    template <typename T>
    static constexpr bool kCompensated = std::is_same_v<T, double>;
    template <typename T>
    static constexpr int kEdge =
        std::is_same_v<T, float> ? 64 : TileEdge<T>::value;
    template <typename T>
    static constexpr bool kGuarded = std::is_same_v<T, double>;

    __device__ __forceinline__ static bool in_range(double v) {
        return chi2_f64_in_range(v);
    }

    __device__ __forceinline__ static void step(float& acc, float x, float y) {
        const float den = (x + y) + 1e-30f;
        const float diff = x - y;
        acc = fmaf(diff, diff * sfu_reciprocal(den), acc);
    }
    // diff^2 / den rounded as the IEEE divide rounds it; the select keeps
    // 0/0 out (there r is inf and the sequence NaN), so the zero-loaded
    // feature tail adds nothing
    __device__ __forceinline__ static void step(double& acc, double x,
                                                double y) {
        const double den = x + y;
        const double diff = x - y;
        const double num = diff * diff;
        double r = sfu_reciprocal(den);
        r = fma(r, fma(-den, r, 1.0), r);
        r = fma(r, fma(-den, r, 1.0), r);
        const double q = num * r;
        const double quotient = fma(fma(-den, q, num), r, q);
        acc += den != 0.0 ? quotient : 0.0;
    }

    // a chunk with a value outside chi2_f64_in_range: the IEEE divide
    struct Outside : TileDefaults {
        template <typename T>
        static constexpr int kUnroll = 1;

        __device__ __forceinline__ static void step(double& acc, double x,
                                                    double y) {
            const double den = x + y;
            const double diff = x - y;
            acc += den != 0.0 ? diff * diff / den : 0.0;
        }
    };
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

// chunk_pass of the operation Op on a staged chunk, or of Op::Outside when
// Op is guarded on T and the chunk holds a value outside its range
// (``in_range`` false, the same in every thread of the block).
template <typename T, int BM, typename Op>
__device__ __forceinline__ void op_pass(
    const Staging<T, BM>& s, T (&sums)[BM / kThreads][BM / kThreads],
    bool in_range) {
    if constexpr (Op::template kGuarded<T>) {
        if (!in_range) {
            using Outside = typename Op::Outside;
            chunk_pass<T, BM, Outside, Outside::template kUnroll<T>>(s, sums);
            return;
        }
    }
    chunk_pass<T, BM, Op, Op::template kUnroll<T>>(s, sums);
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
    // the compensated sum's running error, and whether it still runs: only
    // while every chunk so far passed Op's guard (out of range a partial
    // may be infinite, and inf - inf would make the compensation NaN; the
    // plain sum stays inf)
    T comp[R][R];
    bool compensate = true;
    if constexpr (Op::template kCompensated<T>) {
#pragma unroll
        for (int a = 0; a < R; ++a) {
#pragma unroll
            for (int b = 0; b < R; ++b) {
                comp[a][b] = T(0);
            }
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
        bool in_range = true;  // every value of the chunk passes Op's guard
        if constexpr (Op::template kGuarded<T>) {
            // each thread tests the values it staged, then the block agrees
            for (int e = tid; e < BM * kChunk; e += kThreads * kThreads) {
                const int r = kFeatureMajor ? e % BM : e / kChunk;
                const int kk = kFeatureMajor ? e / BM : e % kChunk;
                in_range &= Op::in_range(s.x[kk][r]) & Op::in_range(s.y[kk][r]);
            }
            in_range = __syncthreads_and(in_range) != 0;
            compensate = compensate && in_range;
        } else {
            __syncthreads();
        }
        if constexpr (Op::template kChunkSums<T>) {
            T part[R][R];
#pragma unroll
            for (int a = 0; a < R; ++a) {
#pragma unroll
                for (int b = 0; b < R; ++b) {
                    part[a][b] = T(0);
                }
            }
            op_pass<T, BM, Op>(s, part, in_range);
#pragma unroll
            for (int a = 0; a < R; ++a) {
#pragma unroll
                for (int b = 0; b < R; ++b) {
                    if constexpr (Op::template kCompensated<T>) {
                        if (compensate) {
                            const T y = part[a][b] - comp[a][b];
                            const T t = acc[a][b] + y;
                            comp[a][b] = (t - acc[a][b]) - y;
                            acc[a][b] = t;
                        } else {
                            acc[a][b] += part[a][b];
                        }
                    } else {
                        acc[a][b] += part[a][b];
                    }
                }
            }
        } else {
            op_pass<T, BM, Op>(s, acc, in_range);
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
// kernel tile kv in registers of tile (it, jt), the partials
// sum_j kv[r][j] V[j, c] of the tile's rows and, off the diagonal,
// sum_r kv[r][j] V[r, c] of its columns, for every class c, into their
// slots of the pass (fixed_sum.cuh: row r's partial from partner jt, column
// j's from partner it).  V is (m, C) row-major; the V rows of both tiles
// are staged kClassChunk classes at a time in v_cols / v_rows, the column
// partials are reduced through col_part.
template <typename T, int BM>
__device__ __forceinline__ void sym_class_loop(
    const T (&kv)[BM / kThreads][BM / kThreads], const T* __restrict__ V,
    T* __restrict__ ws, const SymPass& pass, int64_t m, int64_t C,
    int64_t it, int64_t jt, T (*v_cols)[BM + 1], T (*v_rows)[BM + 1],
    T (*col_part)[BM]) {
    constexpr int R = BM / kThreads;
    const int tx = threadIdx.x;
    const int ty = threadIdx.y;
    const int tid = ty * kThreads + tx;
    const int64_t row0 = it * BM;
    const int64_t col0 = jt * BM;
    const bool off_diagonal = jt > it;  // uniform per block
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
                    ws[pass.slot(r, jt) + c] = total;
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
                        ws[pass.slot(col0 + j, it) + c] = total;
                    }
                }
                __syncthreads();  // col_part is written again next class
            }
        }
    }
}

// The class loop of the rectangular block matmats (kernels D and H): the
// partials sum_j kv[r][j] A[j, c] of the point tile's rows into their
// slots ws[(q ws_rows + r) C + c], q the SV tile; A (n_s, C) staged
// kClassChunk classes at a time in a_cols.
template <typename T, int BM>
__device__ __forceinline__ void rect_class_loop(
    const T (&kv)[BM / kThreads][BM / kThreads], const T* __restrict__ A,
    T* __restrict__ ws, int64_t ws_rows, int64_t n_p, int64_t n_s, int64_t C,
    int64_t row0, int64_t col0, T (*a_cols)[BM + 1]) {
    constexpr int R = BM / kThreads;
    const int tx = threadIdx.x;
    const int ty = threadIdx.y;
    T* slot = ws + (col0 / BM) * ws_rows * C;
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
                    slot[r * C + c] = total;
                }
            }
        }
    }
}

}  // namespace
