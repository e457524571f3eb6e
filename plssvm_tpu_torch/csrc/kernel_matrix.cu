// Kernel N: the explicit solver's kernel matrix for the distance kernels
// (laplacian, chi-squared), written by hand for NVIDIA Hopper (sm_90a).
// Bound to PyTorch through a plain C interface and ctypes
// (plssvm_tpu_torch/ops/kernel_matrix.py); built by ops/_build.py.
//
//   K[i, j] = exp(-gamma * dist(x_i, y_j))
//
// kernel_matrix_sym:  K = k(X, X), (m, m), the one-device explicit solve
//   (solver/explicit.py).  A 1-D grid over the upper-triangle BM x BM
//   tiles, as kernel E walks them: each tile is stored at (i, j) and, off
//   the diagonal, transposed at (j, i), so half the pairs are evaluated.
// kernel_matrix_rect: K = k(Xr, Xc), (mr, mc), the ring's row block K_p =
//   k(X_p, X) (parallel/sharded.py); kernel F's 2-D grid of row tiles x
//   column tiles, every pair evaluated.
//
// It replaces no Pallas kernel: plssvm_tpu builds the explicit matrix in
// XLA (plssvm_tpu/solver/explicit.py kernel_matrix_block, a row-blocked
// pairwise reduction and exp).  It is kernel E's register tile
// (gram_tile.cuh gram_tile with the DistanceOp pair operations, so the
// float chi-squared term keeps the approximate reciprocal without the
// Newton step and the double one the divide-free quotient on chunks within
// chi2_f64_in_range) with a store epilogue in place of the row and column
// sums: no atomics, every entry written once, so two builds are bit for bit
// the same and K is exactly symmetric (each pair operation is symmetric in
// its operands).  Out is T, or __nv_bfloat16 for the "bf16" tier, rounded
// at the store as PyTorch rounds a cast (to float first, then to nearest
// even).  Offsets are 64-bit throughout: at m = 59999, K holds 3.6e9
// entries, past INT32_MAX.
//
// What bounds it: the pair work of the distance, as for kernels E and G
// (laplacian two FP32 instructions per pair and feature, chi-squared in
// float one SFU reciprocal, in double 11 FP64 instructions), over half the
// m^2 pairs; the m^2 stores (4.3 ms for 14.4 GB at 3.35 TB/s) are a few
// percent of it at d = 784, but at config 2's 9999 x 200 laplacian (two
// FP32 instructions a pair and feature) the work per byte stored is about
// 8x lower.  The tile's own store writes each of its rows of K as 16
// consecutive entries a half warp; the transpose goes through shared
// memory (store_tile_transposed: the staging buffer, free once the tile is
// summed, holds 32 rows of the tile at a time), so that a warp writes 32
// consecutive entries of one row of K, one 128-byte line in float, where
// writing the registers transposed put 16 rows x 8 bytes, 16 sectors, in
// one warp instruction.

#include <cuda_bf16.h>

#include <type_traits>

#include "gram_tile.cuh"

namespace {

template <typename Out, typename T>
__device__ __forceinline__ void store_entry(Out* __restrict__ K, int64_t at,
                                            T value) {
    if constexpr (std::is_same_v<Out, __nv_bfloat16>) {
        K[at] = __float2bfloat16_rn(static_cast<float>(value));
    } else {
        K[at] = value;
    }
}

// K[r * ldk + c] = kv for the tile's rows r < mr and columns c < mc.
template <typename T, typename Out, int BM>
__device__ __forceinline__ void store_tile(
    const T (&kv)[BM / kThreads][BM / kThreads], Out* __restrict__ K,
    int64_t mr, int64_t mc, int64_t ldk, int64_t row0, int64_t col0) {
    constexpr int R = BM / kThreads;
#pragma unroll
    for (int a = 0; a < R; ++a) {
        const int64_t r = row0 + threadIdx.y + kThreads * a;
#pragma unroll
        for (int b = 0; b < R; ++b) {
            const int64_t c = col0 + threadIdx.x + kThreads * b;
            if (r < mr && c < mc) {
                store_entry(K, r * ldk + c, kv[a][b]);
            }
        }
    }
}

// K[c * m + r] = kv for the tile's rows r < m and columns c < m (m x m
// K): in slabs of 32 rows of the tile (two of a thread's row groups), each
// staged row-major in the staging buffer (a row of BM + 1 values, so that a
// warp reading one column of the slab hits 32 banks), then each warp
// stores one column of the slab at a time, its lanes the slab's 32 rows:
// 32 consecutive entries of row c of K.  The buffer's last readers
// (gram_tile's last chunk, or the previous slab's stores) are done at the
// barrier that opens each slab.
template <typename T, typename Out, int BM>
__device__ __forceinline__ void store_tile_transposed(
    const T (&kv)[BM / kThreads][BM / kThreads], Staging<T, BM>& staging,
    Out* __restrict__ K, int64_t m, int64_t row0, int64_t col0) {
    constexpr int R = BM / kThreads;
    constexpr int kSlab = 2 * kThreads;
    constexpr int kLd = BM + 1;
    constexpr int kWarps = kThreads * kThreads / 32;
    static_assert(R % 2 == 0, "a slab is two of a thread's row groups");
    static_assert(sizeof(T) * kSlab * kLd <= sizeof(Staging<T, BM>),
                  "a slab fits the staging buffer");
    T* slab = reinterpret_cast<T*>(&staging);
    const int tid = threadIdx.y * kThreads + threadIdx.x;
    const int lane = tid % 32;
    const int warp = tid / 32;
#pragma unroll
    for (int a0 = 0; a0 < R; a0 += 2) {
        __syncthreads();
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int b = 0; b < R; ++b) {
                slab[(threadIdx.y + kThreads * h) * kLd + threadIdx.x +
                     kThreads * b] = kv[a0 + h][b];
            }
        }
        __syncthreads();
        const int64_t r = row0 + kThreads * a0 + lane;
        for (int c = warp; c < BM; c += kWarps) {
            const int64_t gc = col0 + c;
            if (r < m && gc < m) {
                store_entry(K, gc * m + r, slab[lane * kLd + c]);
            }
        }
    }
}

template <typename T, typename Out, int KIND>
__global__ void __launch_bounds__(kThreads * kThreads)
    kernel_matrix_sym_kernel(const T* __restrict__ X, Out* __restrict__ K,
                             int64_t m, int64_t d, T gamma) {
    constexpr int BM = kDistanceEdge<T, KIND>;
    constexpr int R = BM / kThreads;
    __shared__ Staging<T, BM> staging;

    int64_t it, jt;
    upper_triangle_tile(blockIdx.x, it, jt);
    const int64_t row0 = it * BM;
    const int64_t col0 = jt * BM;

    T kv[R][R];
    gram_tile<T, BM, typename DistanceOp<KIND>::type>(X, X, m, m, d, row0,
                                                      col0, staging, kv);
    distance_kernel_tile<T, BM>(kv, m, m, row0, col0, gamma);
    store_tile<T, Out, BM>(kv, K, m, m, m, row0, col0);
    if (jt > it) {  // uniform per block
        store_tile_transposed<T, Out, BM>(kv, staging, K, m, row0, col0);
    }
}

template <typename T, typename Out, int KIND>
__global__ void __launch_bounds__(kThreads * kThreads)
    kernel_matrix_rect_kernel(const T* __restrict__ Xr,
                              const T* __restrict__ Xc, Out* __restrict__ K,
                              int64_t mr, int64_t mc, int64_t d,
                              int64_t n_ctiles, T gamma) {
    constexpr int BM = kDistanceEdge<T, KIND>;
    constexpr int R = BM / kThreads;
    __shared__ Staging<T, BM> staging;

    // consecutive blocks share a row tile and walk the column tiles
    const int64_t p = blockIdx.x;
    const int64_t row0 = (p / n_ctiles) * BM;
    const int64_t col0 = (p % n_ctiles) * BM;

    T kv[R][R];
    gram_tile<T, BM, typename DistanceOp<KIND>::type>(Xr, Xc, mr, mc, d, row0,
                                                      col0, staging, kv);
    distance_kernel_tile<T, BM>(kv, mr, mc, row0, col0, gamma);
    store_tile<T, Out, BM>(kv, K, mr, mc, mc, row0, col0);
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

template <typename T, typename Out>
int matrix_sym(const T* X, void* K, int64_t m, int64_t d, int kind, T gamma,
               void* stream) {
    return by_kind(kind, [&](auto k) {
        constexpr int KIND = decltype(k)::value;
        constexpr int BM = kDistanceEdge<T, KIND>;
        const int64_t nt = (m + BM - 1) / BM;
        const int64_t blocks = nt * (nt + 1) / 2;
        if (m <= 0 || d <= 0 || blocks > INT32_MAX) {
            return static_cast<int>(cudaErrorInvalidValue);
        }
        kernel_matrix_sym_kernel<T, Out, KIND>
            <<<static_cast<unsigned int>(blocks), dim3(kThreads, kThreads), 0,
               static_cast<cudaStream_t>(stream)>>>(
                X, static_cast<Out*>(K), m, d, gamma);
        return static_cast<int>(cudaGetLastError());
    });
}

template <typename T, typename Out>
int matrix_rect(const T* Xr, const T* Xc, void* K, int64_t mr, int64_t mc,
                int64_t d, int kind, T gamma, void* stream) {
    return by_kind(kind, [&](auto k) {
        constexpr int KIND = decltype(k)::value;
        constexpr int BM = kDistanceEdge<T, KIND>;
        const int64_t n_ctiles = (mc + BM - 1) / BM;
        const int64_t blocks = ((mr + BM - 1) / BM) * n_ctiles;
        if (mr <= 0 || mc <= 0 || d <= 0 || blocks > INT32_MAX) {
            return static_cast<int>(cudaErrorInvalidValue);
        }
        kernel_matrix_rect_kernel<T, Out, KIND>
            <<<static_cast<unsigned int>(blocks), dim3(kThreads, kThreads), 0,
               static_cast<cudaStream_t>(stream)>>>(
                Xr, Xc, static_cast<Out*>(K), mr, mc, d, n_ctiles, gamma);
        return static_cast<int>(cudaGetLastError());
    });
}

}  // namespace

// The C interface: every entry point returns the cudaError_t of its launch
// (0 on success).  kind is KernelFunctionType's value (4 laplacian, 5
// chi-squared); K is (m, m) or (mr, mc) row-major, of the input's type, or
// of bfloat16 when out_bf16 is not 0; every entry is written.

extern "C" int plssvm_kernel_matrix_sym_f32(const float* X, void* K,
                                            int64_t m, int64_t d, int kind,
                                            float gamma, int out_bf16,
                                            void* stream) {
    return out_bf16
        ? matrix_sym<float, __nv_bfloat16>(X, K, m, d, kind, gamma, stream)
        : matrix_sym<float, float>(X, K, m, d, kind, gamma, stream);
}

extern "C" int plssvm_kernel_matrix_sym_f64(const double* X, void* K,
                                            int64_t m, int64_t d, int kind,
                                            double gamma, int out_bf16,
                                            void* stream) {
    return out_bf16
        ? matrix_sym<double, __nv_bfloat16>(X, K, m, d, kind, gamma, stream)
        : matrix_sym<double, double>(X, K, m, d, kind, gamma, stream);
}

extern "C" int plssvm_kernel_matrix_rect_f32(const float* Xr, const float* Xc,
                                             void* K, int64_t mr, int64_t mc,
                                             int64_t d, int kind, float gamma,
                                             int out_bf16, void* stream) {
    return out_bf16
        ? matrix_rect<float, __nv_bfloat16>(Xr, Xc, K, mr, mc, d, kind, gamma,
                                            stream)
        : matrix_rect<float, float>(Xr, Xc, K, mr, mc, d, kind, gamma,
                                    stream);
}

extern "C" int plssvm_kernel_matrix_rect_f64(const double* Xr,
                                             const double* Xc, void* K,
                                             int64_t mr, int64_t mc,
                                             int64_t d, int kind,
                                             double gamma, int out_bf16,
                                             void* stream) {
    return out_bf16
        ? matrix_rect<double, __nv_bfloat16>(Xr, Xc, K, mr, mc, d, kind,
                                             gamma, stream)
        : matrix_rect<double, double>(Xr, Xc, K, mr, mc, d, kind, gamma,
                                      stream);
}
