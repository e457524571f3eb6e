// Kernel O: the batched pair-machine matvec of one-vs-one training, written
// by hand for NVIDIA Hopper (sm_90a).  Bound to PyTorch through a plain C
// interface and ctypes (plssvm_tpu_torch/ops/pairs.py); built by
// ops/_build.py.
//
//   out[p, i] = sum_{j < len[p]} k(Xb[p, i], Xb[p, j]) * V[p, j]  for i < len[p]
//
// Xb is (P, m_pad, d): machine p's rows, the first len[p] of them real;
// sq_b (P, m_pad) their squared norms (read by the Gram kinds only), V and
// out (P, m_pad).  Rows past len[p] are neither read nor written: the
// wrapper's zeroed output keeps them 0.  All C(C-1)/2 one-vs-one machines
// of a batched pairs CG (solver/cg.py solve_ls_svm_pairs) take one product
// per iteration: the walk and its reduction, two launches.
//
// It replaces no Pallas kernel: plssvm_tpu computes this product in XLA,
// a vmapped row-scan matvec (plssvm_tpu/solver/cg.py:1104-1105), and keeps
// it out of Pallas on purpose (:1094-1103).  It exists because the port's
// plain version of that product, one plain matvec per machine, is far too
// slow to serve on the card (the plain chi-squared matvec takes ~2 s at
// 16384 x 256, kernel G 10.7 ms).
//
// The walk: each machine's upper triangle of tiles, once.  Machine p has
// T = ceil(len[p] / BM) tiles a side, grouped S = ceil(T / kGroups) to a
// group, so g = ceil(T / S) <= kGroups groups a side; S and g depend on
// len[p] alone.  The grid is (kGroups (kGroups + 1) / 2, machines):
// blockIdx.y is the machine (P <= 65535), blockIdx.x a group pair I <= J
// (upper_triangle_tile); a block whose J is at or past g exits at once, so
// unbalanced classes cost only their own tiles.  The others walk the S x S
// tile pairs (a, b) of their group pair, a in I, b in J (on the diagonal
// group only a <= b), each one the register tile of gram_tile.cuh (the
// Gram FFMA tile of kernel A's "highest" tier for polynomial, RBF and
// sigmoid; the DistanceOp pair operations of kernels E-H for laplacian and
// chi-squared, so float chi-squared keeps the approximate reciprocal and
// double chi-squared the divide-free quotient on chunks within
// chi2_f64_in_range) turned into kernel values.  Every pair op is
// symmetric bit for bit ((x - y)^2 and x + y, |x - y|, x y; the norms
// sq_r + sq_c), so one value k(x_i, x_j) of an off-diagonal tile serves
// both out[i] += k v[j] (the row sums, R a thread in registers across the
// tile row's column tiles, then a half-warp sum) and out[j] += k v[i] (the
// column sums: a fixed sum over the 16 threads of a column through shared
// memory, added in tile-row order to a slot of the workspace that only
// this block writes).  A diagonal tile adds its full square to the row
// sums and nothing to the column sums.
//
// The workspace (plssvm_pairs_workspace_elements values, which the
// wrapper makes per product) holds per machine kGroups x (kGroups + 1)
// slots of W = S(m_pad) BM values:
// slot (I, J) the partials of group I's rows against group J's columns,
// written once by block (I, J) for J >= I (its row sums) or by block (J,
// I) for J < I (its column sums), and slot (I, kGroups) the diagonal
// block's column partials of group I.  A second launch (pairs_reduce)
// sums each row's g + 1 slots, J = 0 .. g - 1 and then the diagonal
// column slot, and stores the row once.  No atomics: every slot and every
// output is written by one thread in an order fixed by len[p], so two
// launches on the same input are bit for bit the same and a machine's
// output does not depend on P, on m_pad or on its neighbours (the slot
// width W is layout only).  The walk computes at full precision (FP32
// FFMA, or float64): ops/pairs.py sends it the distance kinds and the Gram
// kinds in float32 at "highest"; the Gram kinds at "f32" / "bf16", and in
// float64, take the tensor-core walks of pairs_tc.cu at the fit's tier
// (the reference's batched product is one bf16 MXU pass, its "f32" tier;
// pairs_tc.cu's note).  Offsets are 64-bit.
//
// What bounds it: the pair work, the sum_p len[p] (len[p] + 1) / 2
// distinct pairs times d (the triangle walks T (T + 1) / 2 tiles a
// machine: those pairs, the lower halves of the diagonal tiles and the
// last tile's padding), times PAIR_FEATURE_COST (one FFMA per Gram pair and feature, two FP32
// instructions laplacian, four and one SFU reciprocal float chi-squared;
// PAIR_FEATURE_COST_F64 in double) at 33.5 T FP32 instructions/s, 4.2 T
// SFU results/s or 17 T FP64 instructions/s on an H100 SXM; beside it two
// FFMAs per pair of the contraction (one each way).  The bytes (each
// machine's rows once, the workspace's slots written and read once) are
// far below it at the widths OAO trains at.  The FFMA Gram product stops
// at the 67 TFLOP/s FP32 rate, which is why the Gram kinds moved to the
// tensor cores at the tiers that allow it.

#include "gram_tile.cuh"

namespace {

// The most groups of tiles a side of a machine falls into: the walk's grid
// has kGroups (kGroups + 1) / 2 blocks a machine.
constexpr int64_t kGroups = 16;
// threads of a block of the reduction, one row each
constexpr int kReduceThreads = 256;

// The pair operation of kind KIND: the Gram product, or the distance term.
template <int KIND, bool kDistance = (KIND == kLaplacian || KIND == kChiSquared)>
struct PairOp {
    using type = GramProduct;
};
template <int KIND>
struct PairOp<KIND, true> {
    using type = typename DistanceOp<KIND>::type;
};

// The tile edge of kind KIND on T: its pair operation's (TileEdge for the
// Gram kinds, kDistanceEdge for the distance ones).
template <typename T, int KIND>
constexpr int kPairsEdge = PairOp<KIND>::type::template kEdge<T>;

// A machine of m rows at tile edge BM: its tiles a side, the tiles of a
// group and its groups a side (0, 0, 0 for m = 0).
struct Grouping {
    int64_t tiles;
    int64_t per_group;
    int64_t groups;
};

__host__ __device__ __forceinline__ Grouping grouping(int64_t m, int64_t BM) {
    const int64_t tiles = (m + BM - 1) / BM;
    const int64_t per_group = (tiles + kGroups - 1) / kGroups;
    return {tiles, per_group, per_group == 0 ? 0 : (tiles + per_group - 1) / per_group};
}

// Offset of slot (I, J) of machine p in the workspace: kGroups x (kGroups
// + 1) slots of ``width`` values a machine.
__host__ __device__ __forceinline__ int64_t slot(int64_t p, int64_t I, int64_t J,
                                                 int64_t width) {
    return ((p * kGroups + I) * (kGroups + 1) + J) * width;
}

// Blocks an SM that the walk's registers must allow: two (at most 128
// registers a thread), but one for double chi-squared, whose compensated
// chunk sums take more.  Left to itself the compiler gave the float Gram
// and laplacian tiles ~190 registers, one block an SM; at 128 they spill
// 48-84 bytes and still run faster.
template <typename T, int KIND>
constexpr int kPairsMinBlocks = std::is_same_v<T, double> && KIND == kChiSquared ? 1 : 2;

template <typename T, int KIND>
__global__ void __launch_bounds__(kThreads * kThreads, kPairsMinBlocks<T, KIND>)
    pairs_matvec_kernel(const T* __restrict__ Xb, const T* __restrict__ sq_b,
                        const T* __restrict__ V, const int64_t* __restrict__ len,
                        T* __restrict__ ws, int64_t m_pad, int64_t d,
                        int64_t width, int degree, T gamma, T coef0) {
    constexpr bool kDistance = KIND == kLaplacian || KIND == kChiSquared;
    constexpr int BM = kPairsEdge<T, KIND>;
    constexpr int R = BM / kThreads;
    __shared__ Staging<T, BM> staging;
    __shared__ T col_part[kThreads][BM];

    const int64_t p = blockIdx.y;
    const int64_t m = len[p];
    const Grouping g = grouping(m, BM);
    int64_t gi64, gj64;
    upper_triangle_tile(blockIdx.x, gi64, gj64);
    if (gj64 >= g.groups) {  // uniform per block
        return;
    }
    // tile indices in 32 bits (the launch checks m_pad's tiles fit), which
    // keeps the float tiles within 128 registers
    const int gi = static_cast<int>(gi64);
    const int gj = static_cast<int>(gj64);
    const int per_group = static_cast<int>(g.per_group);
    const int tiles = static_cast<int>(g.tiles);
    const T* X = Xb + p * m_pad * d;
    const T* sq = kDistance ? nullptr : sq_b + p * m_pad;
    const T* v = V + p * m_pad;
    const bool diagonal = gi == gj;
    const int a_first = gi * per_group;
    const int a_end = a_first + per_group < tiles ? a_first + per_group : tiles;
    const int b_first = gj * per_group;
    const int b_end = b_first + per_group < tiles ? b_first + per_group : tiles;
    const int tx = threadIdx.x;
    const int ty = threadIdx.y;
    const int tid = ty * kThreads + tx;

    for (int a = a_first; a < a_end; ++a) {
        const int64_t row0 = static_cast<int64_t>(a) * BM;
        T row_sum[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
            row_sum[i] = T(0);
        }
        for (int b = diagonal ? a : b_first; b < b_end; ++b) {
            const int64_t col0 = static_cast<int64_t>(b) * BM;
            T kv[R][R];
            gram_tile<T, BM, typename PairOp<KIND>::type>(X, X, m, m, d, row0,
                                                          col0, staging, kv);
            if constexpr (kDistance) {
                distance_kernel_tile<T, BM>(kv, m, m, row0, col0, gamma);
            } else {
                kernel_tile<T, KIND, BM>(kv, sq, sq, m, m, row0, col0, degree,
                                         gamma, coef0);
            }
            T vc[R];
#pragma unroll
            for (int j = 0; j < R; ++j) {
                const int64_t c = col0 + tx + kThreads * j;
                vc[j] = c < m ? v[c] : T(0);
            }
#pragma unroll
            for (int i = 0; i < R; ++i) {
#pragma unroll
                for (int j = 0; j < R; ++j) {
                    row_sum[i] += kv[i][j] * vc[j];
                }
            }
            // the column partials: none from a diagonal tile, which the row
            // sums take whole; the first tile row of the group pair writes
            // its slot values, the later ones add to them
            if (b != a) {
                // the tile row's right-hand side, read here (from L1) and
                // not held across the tile: the float tiles keep to 128
                // registers, two blocks an SM
                T vr[R];
#pragma unroll
                for (int i = 0; i < R; ++i) {
                    const int64_t r = row0 + ty + kThreads * i;
                    vr[i] = r < m ? v[r] : T(0);
                }
#pragma unroll
                for (int j = 0; j < R; ++j) {
                    T col_sum = T(0);
#pragma unroll
                    for (int i = 0; i < R; ++i) {
                        col_sum += kv[i][j] * vr[i];
                    }
                    col_part[ty][tx + kThreads * j] = col_sum;
                }
                __syncthreads();
            }
            if (tid < BM && (b != a || a == a_first)) {
                T total = T(0);
                if (b != a) {
#pragma unroll
                    for (int y = 0; y < kThreads; ++y) {
                        total += col_part[y][tid];
                    }
                }
                // group gj's columns' partials against group gi (on the
                // diagonal group, the extra slot kGroups)
                T* dst = ws + slot(p, gj, diagonal ? kGroups : gi, width)
                    + (b - b_first) * BM + tid;
                *dst = a == a_first ? total : *dst + total;
            }
            __syncthreads();  // col_part and the staging are written again
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
            const T total = half_warp_sum(row_sum[i]);
            if (tx == 0) {  // the rows' partials against group gj
                ws[slot(p, gi, gj, width) + (a - a_first) * BM + ty + kThreads * i] = total;
            }
        }
    }
}

// out[p, r] = the sum of row r's slots, J = 0 .. g - 1 of its group I and
// then the diagonal column slot (I, kGroups), for r < len[p]; one thread a
// row.
template <typename T, int BM>
__global__ void __launch_bounds__(kReduceThreads)
    pairs_reduce_kernel(const T* __restrict__ ws, const int64_t* __restrict__ len,
                        T* __restrict__ out, int64_t m_pad, int64_t width) {
    const int64_t p = blockIdx.y;
    const int64_t r = static_cast<int64_t>(blockIdx.x) * kReduceThreads + threadIdx.x;
    const int64_t m = len[p];
    if (r >= m) {
        return;
    }
    const Grouping g = grouping(m, BM);
    const int64_t span = g.per_group * BM;  // the rows of a group
    const int64_t gi = r / span;
    const T* slots = ws + slot(p, gi, 0, width) + (r - gi * span);
    T total = T(0);
    for (int64_t j = 0; j < g.groups; ++j) {
        total += slots[j * width];
    }
    total += slots[kGroups * width];
    out[p * m_pad + r] = total;
}

template <typename T, int KIND>
int launch(const T* Xb, const T* sq_b, const T* V, const int64_t* len, T* out,
           T* ws, int64_t P, int64_t m_pad, int64_t d, int degree, T gamma,
           T coef0, void* stream) {
    constexpr int BM = kPairsEdge<T, KIND>;
    const int64_t row_blocks = (m_pad + kReduceThreads - 1) / kReduceThreads;
    const Grouping padded = grouping(m_pad, BM);
    if (P <= 0 || P > 65535 || m_pad <= 0 || d < 0 || row_blocks > INT32_MAX
        || padded.tiles > INT32_MAX) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int64_t width = padded.per_group * BM;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 grid(static_cast<unsigned int>(kGroups * (kGroups + 1) / 2),
                    static_cast<unsigned int>(P));
    pairs_matvec_kernel<T, KIND><<<grid, dim3(kThreads, kThreads), 0, s>>>(
        Xb, sq_b, V, len, ws, m_pad, d, width, degree, gamma, coef0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    const dim3 rows(static_cast<unsigned int>(row_blocks), static_cast<unsigned int>(P));
    pairs_reduce_kernel<T, BM><<<rows, kReduceThreads, 0, s>>>(ws, len, out, m_pad, width);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int pairs(const T* Xb, const T* sq_b, const T* V, const int64_t* len, T* out,
          T* ws, int64_t P, int64_t m_pad, int64_t d, int kind, int degree,
          T gamma, T coef0, void* stream) {
    switch (kind) {
        case kPolynomial:
            return launch<T, kPolynomial>(Xb, sq_b, V, len, out, ws, P, m_pad, d,
                                          degree, gamma, coef0, stream);
        case kRbf:
            return launch<T, kRbf>(Xb, sq_b, V, len, out, ws, P, m_pad, d, degree,
                                   gamma, coef0, stream);
        case kSigmoid:
            return launch<T, kSigmoid>(Xb, sq_b, V, len, out, ws, P, m_pad, d,
                                       degree, gamma, coef0, stream);
        case kLaplacian:
            return launch<T, kLaplacian>(Xb, sq_b, V, len, out, ws, P, m_pad, d,
                                         degree, gamma, coef0, stream);
        case kChiSquared:
            return launch<T, kChiSquared>(Xb, sq_b, V, len, out, ws, P, m_pad, d,
                                          degree, gamma, coef0, stream);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}

// The values of the FFMA walk's workspace for P machines padded to m_pad
// rows of kind KIND in float (is_double 0) or double: P kGroups (kGroups +
// 1) slots of S(m_pad) BM values.  As kGroups S < T + kGroups, that is
// under (kGroups + 1) (m_pad + kGroups BM) a machine.  -1 for a kind the
// walk does not take or a negative size.
template <typename T, int KIND>
int64_t workspace_elements(int64_t P, int64_t m_pad) {
    constexpr int BM = kPairsEdge<T, KIND>;
    return P * kGroups * (kGroups + 1) * grouping(m_pad, BM).per_group * BM;
}

template <typename T>
int64_t workspace_elements(int64_t P, int64_t m_pad, int kind) {
    switch (kind) {
        case kPolynomial:
            return workspace_elements<T, kPolynomial>(P, m_pad);
        case kRbf:
            return workspace_elements<T, kRbf>(P, m_pad);
        case kSigmoid:
            return workspace_elements<T, kSigmoid>(P, m_pad);
        case kLaplacian:
            return workspace_elements<T, kLaplacian>(P, m_pad);
        case kChiSquared:
            return workspace_elements<T, kChiSquared>(P, m_pad);
        default:
            return -1;
    }
}

}  // namespace

// The C interface: every entry point returns the cudaError_t of its
// launches (0 on success).  kind is KernelFunctionType's value (1
// polynomial, 2 RBF, 3 sigmoid, 4 laplacian, 5 chi-squared; not 0,
// linear); sq_b may be null for the distance kinds; len (P,) int64 on the
// device, each <= m_pad; out must hold zeros: rows past len[p] are not
// written; workspace plssvm_pairs_workspace_elements(P, m_pad, kind,
// is_double) values of the type, whose contents on entry do not matter.

extern "C" int64_t plssvm_pairs_workspace_elements(int64_t P, int64_t m_pad, int kind,
                                                   int is_double) {
    if (P < 0 || m_pad < 0) {
        return -1;
    }
    return is_double ? workspace_elements<double>(P, m_pad, kind)
                     : workspace_elements<float>(P, m_pad, kind);
}

extern "C" int plssvm_pairs_matvec_f32(const float* Xb, const float* sq_b,
                                       const float* V, const int64_t* len,
                                       float* out, float* workspace, int64_t P,
                                       int64_t m_pad, int64_t d, int kind,
                                       int degree, float gamma, float coef0,
                                       void* stream) {
    return pairs<float>(Xb, sq_b, V, len, out, workspace, P, m_pad, d, kind,
                        degree, gamma, coef0, stream);
}

extern "C" int plssvm_pairs_matvec_f64(const double* Xb, const double* sq_b,
                                       const double* V, const int64_t* len,
                                       double* out, double* workspace, int64_t P,
                                       int64_t m_pad, int64_t d, int kind,
                                       int degree, double gamma, double coef0,
                                       void* stream) {
    return pairs<double>(Xb, sq_b, V, len, out, workspace, P, m_pad, d, kind,
                         degree, gamma, coef0, stream);
}
