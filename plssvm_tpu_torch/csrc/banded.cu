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
// The epilogue sums each tile's rows for out_r (half-warp shuffle, one
// slot per row and partner tile) and its columns (shared memory, one slot
// per column and partner tile) for the half the split names; fixed_sum.cuh
// adds each output's slots in partner order.  An f64 tile (64 rows) lies inside a
// 128-row band, so the column target is chosen from the bands of the
// tile's first row and column, not from the tile index: an off-diagonal
// tile whose rows and columns share a band mirrors its pairs into out_r.
// The band follows the row index, so a ragged last band splits the same.
//
// Not carried over from the TPU: the roll walk (rows on lanes, one rolled
// band per step), which avoided a cross-lane reduction the GPU does not
// have; the resident column accumulator (the slots replace it); the m % 128
// and d % 8 layout rules (ragged rows and features are masked).
//
// What bounds it: as kernel E, the pair operation on the CUDA cores, two
// FP32 instructions (a subtract, an add with the |.| modifier) per pair and
// feature; m (m + 1) / 2 pairs when symmetric.  The operand is read once
// per tile from L2; device memory is not the limit.  Every sum across
// blocks is taken in an order fixed by the shapes (fixed_sum.cuh).

#include "gram_tile.cuh"

namespace {

constexpr int kBand = 128;  // rows per band of the split

// Where a tile's row and column partials go.  Symmetric: the pass's slots
// (fixed_sum.cuh SymPass) of out_r (ws_r) and of out_c (ws_c), partner
// tiles as the triangle's.  Not symmetric (one band of row tiles from t0):
// the row partials of tile (it, jt) in ws_r[jt ws_rows + r - t0 BM], its
// column partials in ws_c[(it - t0) m + j].
struct BandedSlots {
    SymPass pass;
    int64_t t0;
    int64_t ws_rows;
};

template <typename T>
__global__ void __launch_bounds__(kThreads * kThreads)
    banded_matvec_kernel(const T* __restrict__ XT, const T* __restrict__ v,
                         T* __restrict__ ws_r, T* __restrict__ ws_c,
                         const BandedSlots slots, int64_t m, int64_t d,
                         int64_t n_tiles, int symmetric, T gamma) {
    constexpr int BM = TileEdge<T>::value;
    constexpr int R = BM / kThreads;
    static_assert(kBand % BM == 0, "a tile lies inside one band");
    __shared__ Staging<T, BM> staging;
    __shared__ T col_part[kThreads][BM];

    int64_t it, jt;
    if (symmetric) {
        upper_triangle_tile(slots.pass.first_block() + blockIdx.x, it, jt);
    } else {
        it = slots.t0 + blockIdx.x / n_tiles;
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
        const int64_t r = row0 + ty + kThreads * a;
        if (tx == 0 && row_ok[a]) {
            ws_r[symmetric ? slots.pass.slot(r, jt)
                           : jt * slots.ws_rows + r - slots.t0 * BM] = total;
        }
    }
    // where the tile's column sums go (uniform per block): every tile's to
    // out_c when not symmetric; when symmetric, none from a diagonal tile
    // (its full block went to out_r), and from an off-diagonal tile to
    // out_c across bands or to out_r within one band
    T* col_out = ws_c;
    if (symmetric) {
        col_out = jt == it ? nullptr
                  : (row0 / kBand < col0 / kBand ? ws_c : ws_r);
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
            const int64_t j = col0 + c;
            if (j < m) {
                col_out[symmetric ? slots.pass.slot(j, it)
                                  : (it - slots.t0) * m + j] = total;
            }
        }
    }
}

// Symmetric: the triangle in the passes of sym_plan, each pass's slots of
// out_r and of out_c zeroed first (a row's partner gives it a partial in
// one of the two only).  Not symmetric: bands of row tiles (row_plan),
// every tile's partials in their slots.
template <typename T>
int banded_matvec(const T* XT, const T* v, T* out_r, T* out_c, int64_t m,
                  int64_t d, int symmetric, T gamma, const Workspace& workspace,
                  void* stream) {
    constexpr int BM = TileEdge<T>::value;
    const int64_t nt = (m + BM - 1) / BM;
    if (m <= 0 || d < 0) {
        return cudaErrorInvalidValue;
    }
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 threads(kThreads, kThreads);
    cudaError_t err;
    if (symmetric) {
        const std::vector<SymPass> passes = sym_plan(m, BM, 1, 1, 2 * sizeof(T));
        if (!take_workspace(workspace, 2 * sym_plan_bytes(passes, sizeof(T)),
                            err)) {
            return err;
        }
        for (const SymPass& pass : passes) {
            T* ws_r = static_cast<T*>(workspace.base);
            T* ws_c = ws_r + pass.values();
            if (pass.blocks() > INT32_MAX) {
                return cudaErrorInvalidValue;
            }
            err = cudaMemsetAsync(ws_r, 0, 2 * sizeof(T) * pass.values(), s);
            if (err != cudaSuccess) {
                return err;
            }
            banded_matvec_kernel<T>
                <<<static_cast<unsigned int>(pass.blocks()), threads, 0, s>>>(
                    XT, v, ws_r, ws_c, BandedSlots{pass, 0, 0}, m, d, nt,
                    symmetric, gamma);
            err = cudaGetLastError();
            if (err == cudaSuccess) {
                err = sym_pass_sums(ws_r, pass, m, out_r, s);
            }
            if (err == cudaSuccess) {
                err = sym_pass_sums(ws_c, pass, m, out_c, s);
            }
            if (err != cudaSuccess) {
                return err;
            }
        }
        return cudaSuccess;
    }
    const RowPlan plan = row_plan(m, BM, sizeof(T), [&](int64_t rows) {
        const int64_t tiles = (rows + BM - 1) / BM;
        return nt * tiles * BM + tiles * m;
    });
    if (!take_workspace(workspace, plan.bytes, err)) {
        return err;
    }
    for (int64_t b = 0; b < plan.bands(); ++b) {
        const int64_t tiles = (plan.rows(b) + BM - 1) / BM;
        const int64_t ws_rows = tiles * BM;
        T* ws_r = static_cast<T*>(workspace.base);
        T* ws_c = ws_r + nt * ws_rows;
        if (tiles * nt > INT32_MAX) {
            return cudaErrorInvalidValue;
        }
        const BandedSlots slots{SymPass{0, 0, BM, 1}, plan.row0(b) / BM, ws_rows};
        banded_matvec_kernel<T>
            <<<static_cast<unsigned int>(tiles * nt), threads, 0, s>>>(
                XT, v, ws_r, ws_c, slots, m, d, nt, symmetric, gamma);
        err = cudaGetLastError();
        if (err == cudaSuccess) {
            err = fixed_sum(ws_r, nt, ws_rows, plan.rows(b),
                            out_r + plan.row0(b), s);
        }
        if (err == cudaSuccess) {
            err = fixed_sum(ws_c, tiles, m, m, out_c, s);
        }
        if (err != cudaSuccess) {
            return err;
        }
    }
    return cudaSuccess;
}

}  // namespace

// The C interface: returns the cudaError_t of the launches (0 on
// success).  XT is (d, m) row-major, v (m,); out_r and out_c (m,) must hold
// zeros: the sums are added to them.  symmetric is 0 or 1.  workspace
// holds *workspace_bytes bytes; a null workspace asks for the bytes the
// call needs, written to *workspace_bytes, and launches nothing
// (fixed_sum.cuh).

extern "C" int plssvm_banded_matvec_f32(const float* XT, const float* v,
                                        float* out_r, float* out_c, int64_t m,
                                        int64_t d, int symmetric, float gamma,
                                        void* workspace,
                                        int64_t* workspace_bytes,
                                        void* stream) {
    return banded_matvec<float>(XT, v, out_r, out_c, m, d, symmetric, gamma,
                                Workspace{workspace, workspace_bytes}, stream);
}

extern "C" int plssvm_banded_matvec_f64(const double* XT, const double* v,
                                        double* out_r, double* out_c,
                                        int64_t m, int64_t d, int symmetric,
                                        double gamma, void* workspace,
                                        int64_t* workspace_bytes,
                                        void* stream) {
    return banded_matvec<double>(XT, v, out_r, out_c, m, d, symmetric, gamma,
                                 Workspace{workspace, workspace_bytes}, stream);
}
