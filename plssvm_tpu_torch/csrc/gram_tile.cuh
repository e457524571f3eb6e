// The pieces the Gram kernels share (gram_matvec.cu: kernels A and B;
// gram_matmat.cu: kernels C and D): the kernel-function epilogue, the
// register-tiled Gram tile with its shared-memory feature-chunk loader, the
// half-warp reduction and the upper-triangle tile walk.
//
// Everything here lives in an unnamed namespace: each .cu file that
// includes it gets its own copy, and the library's only exported symbols
// are the extern "C" entry points of the .cu files.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kPolynomial = 1;  // KernelFunctionType values (parameter.py)
constexpr int kRbf = 2;
constexpr int kSigmoid = 3;

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

template <typename T, int BM>
struct Staging {
    // transposed feature chunks; the +1 spreads the stores over the banks
    T x[kChunk][BM + 1];
    T y[kChunk][BM + 1];
};

// acc[a][b] = sum_k X[row0 + ty + kThreads a, k] * Y[col0 + tx + kThreads b, k]
// over all d features; rows past mx / my and features past d load as 0.
template <typename T, int BM>
__device__ __forceinline__ void gram_tile(
    const T* __restrict__ X, const T* __restrict__ Y, int64_t mx, int64_t my,
    int64_t d, int64_t row0, int64_t col0, Staging<T, BM>& s,
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
        // neighbouring threads read neighbouring features of one row
        for (int e = tid; e < BM * kChunk; e += kThreads * kThreads) {
            const int r = e / kChunk;
            const int kk = e % kChunk;
            const int64_t k = k0 + kk;
            const int64_t gx = row0 + r;
            const int64_t gy = col0 + r;
            s.x[kk][r] = (gx < mx && k < d) ? X[gx * d + k] : T(0);
            s.y[kk][r] = (gy < my && k < d) ? Y[gy * d + k] : T(0);
        }
        __syncthreads();
#pragma unroll
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
                    acc[a][b] += xa[a] * yb[b];
                }
            }
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

}  // namespace
