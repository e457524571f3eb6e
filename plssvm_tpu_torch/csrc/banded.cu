// Kernel I, banded_matvec: the laplacian K(X, X) @ v from the transposed
// operand XT (d, m), returned as two halves split on 128-row bands.
// Written by hand for NVIDIA Hopper (sm_90a); bound to PyTorch through a
// plain C interface and ctypes (plssvm_tpu_torch/ops/banded.py), built by
// ops/_build.py.
//
// Replaces the Pallas kernel tools/exp_banded_distance.py banded_matvec
// (body _banded_kernel).  With k(i, j) = exp(-gamma sum_f |XT[f, i] -
// XT[f, j]|) and b(i) = i / 128 the band of row i:
//
//   symmetric:     out_r[i] = sum_{j : b(j) >= b(i)} k(i, j) v[j]
//                  out_c[j] = sum_{i : b(i) <  b(j)} k(i, j) v[i]
//                  so out_r + out_c = K v; a band's whole 128 x 128 diagonal
//                  block goes to out_r;
//   non-symmetric: out_r = K v and out_c = K^T v, each the full sum.
//
// Kernel E's walk (distance.cu): a 1-D grid over the upper-triangle BM x
// BM tiles (every tile when not symmetric), gram_tile's register tile with
// the L1Distance pair operation, fed by its feature-major loader, so the
// (d, m) operand loads along m, neighbouring threads on neighbouring rows.
// The epilogue sums each tile's rows into out_r (half-warp shuffle, one
// atomic per row) and its columns (shared memory, one atomic per column)
// into the half the split names.  An f64 tile (64 rows) lies inside a
// 128-row band, so the column target is chosen from the bands of the
// tile's first row and column, not from the tile index: an off-diagonal
// tile whose rows and columns share a band mirrors its pairs into out_r.
// The band follows the row index, so a ragged last band splits the same.
//
// Not carried over from the TPU: the roll walk (rows on lanes, one rolled
// band per step), which avoided a cross-lane reduction the GPU does not
// have; the resident column accumulator (atomics replace it); the m % 128
// and d % 8 layout rules (ragged rows and features are masked).
//
// What bounds it: as kernel E, the pair operation on the CUDA cores, two
// FP32 instructions (a subtract, an add with the |.| modifier) per pair and
// feature; m (m + 1) / 2 pairs when symmetric.  The operand is read once
// per tile from L2; device memory is not the limit.  The atomics make the
// summation order change from run to run.

#include "gram_tile.cuh"

namespace {

constexpr int kBand = 128;  // rows per band of the split

template <typename T>
__global__ void __launch_bounds__(kThreads * kThreads)
    banded_matvec_kernel(const T* __restrict__ XT, const T* __restrict__ v,
                         T* __restrict__ out_r, T* __restrict__ out_c,
                         int64_t m, int64_t d, int64_t n_tiles, int symmetric,
                         T gamma) {
    constexpr int BM = TileEdge<T>::value;
    constexpr int R = BM / kThreads;
    static_assert(kBand % BM == 0, "a tile lies inside one band");
    __shared__ Staging<T, BM> staging;
    __shared__ T col_part[kThreads][BM];

    int64_t it, jt;
    if (symmetric) {
        upper_triangle_tile(blockIdx.x, it, jt);
    } else {
        it = blockIdx.x / n_tiles;
        jt = blockIdx.x % n_tiles;
    }
    const int64_t row0 = it * BM;
    const int64_t col0 = jt * BM;

    T acc[R][R];
    gram_tile<T, BM, L1Distance, true>(XT, XT, m, m, d, row0, col0, staging,
                                       acc);

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
            atomicAdd(&out_r[row0 + ty + kThreads * a], total);
        }
    }
    // where the tile's column sums go (uniform per block): every tile's to
    // out_c when not symmetric; when symmetric, none from a diagonal tile
    // (its full block went to out_r), and from an off-diagonal tile to
    // out_c across bands or to out_r within one band
    T* col_out = out_c;
    if (symmetric) {
        col_out = jt == it ? nullptr
                  : (row0 / kBand < col0 / kBand ? out_c : out_r);
    }
    if (col_out != nullptr) {
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
                atomicAdd(&col_out[col0 + c], total);
            }
        }
    }
}

template <typename T>
int banded_matvec(const T* XT, const T* v, T* out_r, T* out_c, int64_t m,
                  int64_t d, int symmetric, T gamma, void* stream) {
    constexpr int BM = TileEdge<T>::value;
    const int64_t nt = (m + BM - 1) / BM;
    const int64_t blocks = symmetric ? nt * (nt + 1) / 2 : nt * nt;
    if (m <= 0 || d < 0 || blocks > INT32_MAX) {
        return cudaErrorInvalidValue;
    }
    banded_matvec_kernel<T>
        <<<static_cast<unsigned int>(blocks), dim3(kThreads, kThreads), 0,
           static_cast<cudaStream_t>(stream)>>>(XT, v, out_r, out_c, m, d, nt,
                                                symmetric, gamma);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The C interface: returns the cudaError_t of the launch (0 on success).
// XT is (d, m) row-major, v (m,); out_r and out_c (m,) must hold zeros: the
// kernel accumulates into them.  symmetric is 0 or 1.

extern "C" int plssvm_banded_matvec_f32(const float* XT, const float* v,
                                        float* out_r, float* out_c, int64_t m,
                                        int64_t d, int symmetric, float gamma,
                                        void* stream) {
    return banded_matvec<float>(XT, v, out_r, out_c, m, d, symmetric, gamma,
                                stream);
}

extern "C" int plssvm_banded_matvec_f64(const double* XT, const double* v,
                                        double* out_r, double* out_c,
                                        int64_t m, int64_t d, int symmetric,
                                        double gamma, void* stream) {
    return banded_matvec<double>(XT, v, out_r, out_c, m, d, symmetric, gamma,
                                 stream);
}
