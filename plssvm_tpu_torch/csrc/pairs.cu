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
// of a batched pairs CG (solver/cg.py solve_ls_svm_pairs) take one launch
// per iteration.
//
// It replaces no Pallas kernel: plssvm_tpu computes this product in XLA,
// a vmapped row-scan matvec (plssvm_tpu/solver/cg.py:1104-1105), and keeps
// it out of Pallas on purpose (:1094-1103).  It exists because the port's
// plain version of that product, one plain matvec per machine, is far too
// slow to serve on the card (the plain chi-squared matvec takes ~2 s at
// 16384 x 256, kernel G 10.7 ms).
//
// The grid is (row tiles, machines): blockIdx.y is the machine (P <=
// 65535), blockIdx.x a BM-row tile of it.  A block whose tile starts at or
// past len[p] exits at once, so unbalanced classes cost only their own
// rows.  The others walk every column tile of their machine, each one the
// register tile of gram_tile.cuh (the Gram FFMA tile of kernel A's
// "highest" tier for polynomial, RBF and sigmoid; the DistanceOp pair
// operations of kernels E-H for laplacian and chi-squared, so float
// chi-squared keeps the approximate reciprocal and double chi-squared the
// divide-free quotient on chunks within chi2_f64_in_range), turn it into
// kernel values and fold K v into R row sums per thread, in registers.
// After the last column tile a half-warp sum gives each row's total, which
// one thread stores.  No atomics: every output is written once, in an
// order fixed by the shapes, so two launches on the same input are bit for
// bit the same and a machine's output does not depend on P or on its
// neighbours.  The price is the full square of each machine's pairs,
// twice the triangle that kernel A's walk evaluates.  This walk computes at
// full precision (FP32 FFMA, or float64): ops/pairs.py sends it the
// distance kinds and the Gram kinds in float32 at "highest"; the Gram kinds
// at "f32" / "bf16", and in float64, take the tensor-core walks of
// pairs_tc.cu at the fit's tier (the reference's batched product is one
// bf16 MXU pass, its "f32" tier; pairs_tc.cu's note).  Offsets are 64-bit.
//
// What bounds it: the pair work, sum_p len[p]^2 d pair-features as walked
// (the bound counts the sum_p len[p] (len[p] + 1) / 2 distinct pairs, so
// the full-square walk reaches at most half of it), times PAIR_FEATURE_COST
// (one FFMA per Gram pair and feature, two FP32 instructions laplacian,
// four and one SFU reciprocal float chi-squared; PAIR_FEATURE_COST_F64 in
// double) at 33.5 T FP32 instructions/s, 4.2 T SFU results/s or 17 T FP64
// instructions/s on an H100 SXM; the bytes (each machine's rows once) are
// far below it at the widths OAO trains at.  The FFMA Gram product stops at
// the 67 TFLOP/s FP32 rate, which is why the Gram kinds moved to the tensor
// cores at the tiers that allow it.

#include "gram_tile.cuh"

namespace {

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

template <typename T, int KIND>
__global__ void __launch_bounds__(kThreads * kThreads)
    pairs_matvec_kernel(const T* __restrict__ Xb, const T* __restrict__ sq_b,
                        const T* __restrict__ V, const int64_t* __restrict__ len,
                        T* __restrict__ out, int64_t m_pad, int64_t d,
                        int degree, T gamma, T coef0) {
    constexpr bool kDistance = KIND == kLaplacian || KIND == kChiSquared;
    constexpr int BM = kPairsEdge<T, KIND>;
    constexpr int R = BM / kThreads;
    __shared__ Staging<T, BM> staging;

    const int64_t p = blockIdx.y;
    const int64_t m = len[p];
    const int64_t row0 = static_cast<int64_t>(blockIdx.x) * BM;
    if (row0 >= m) {  // uniform per block
        return;
    }
    const T* X = Xb + p * m_pad * d;
    const T* sq = kDistance ? nullptr : sq_b + p * m_pad;
    const T* v = V + p * m_pad;
    const int tx = threadIdx.x;
    const int ty = threadIdx.y;

    T row_sum[R];
#pragma unroll
    for (int a = 0; a < R; ++a) {
        row_sum[a] = T(0);
    }
    for (int64_t col0 = 0; col0 < m; col0 += BM) {
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
        for (int b = 0; b < R; ++b) {
            const int64_t c = col0 + tx + kThreads * b;
            vc[b] = c < m ? v[c] : T(0);
        }
#pragma unroll
        for (int a = 0; a < R; ++a) {
#pragma unroll
            for (int b = 0; b < R; ++b) {
                row_sum[a] += kv[a][b] * vc[b];
            }
        }
    }
#pragma unroll
    for (int a = 0; a < R; ++a) {
        const T total = half_warp_sum(row_sum[a]);
        const int64_t r = row0 + ty + kThreads * a;
        if (tx == 0 && r < m) {
            out[p * m_pad + r] = total;
        }
    }
}

template <typename T, int KIND>
int launch(const T* Xb, const T* sq_b, const T* V, const int64_t* len, T* out,
           int64_t P, int64_t m_pad, int64_t d, int degree, T gamma, T coef0,
           void* stream) {
    constexpr int BM = kPairsEdge<T, KIND>;
    const int64_t row_tiles = (m_pad + BM - 1) / BM;
    if (P <= 0 || P > 65535 || m_pad <= 0 || d < 0 || row_tiles > INT32_MAX) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const dim3 grid(static_cast<unsigned int>(row_tiles),
                    static_cast<unsigned int>(P));
    pairs_matvec_kernel<T, KIND>
        <<<grid, dim3(kThreads, kThreads), 0,
           static_cast<cudaStream_t>(stream)>>>(Xb, sq_b, V, len, out, m_pad,
                                                d, degree, gamma, coef0);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int pairs(const T* Xb, const T* sq_b, const T* V, const int64_t* len, T* out,
          int64_t P, int64_t m_pad, int64_t d, int kind, int degree, T gamma,
          T coef0, void* stream) {
    switch (kind) {
        case kPolynomial:
            return launch<T, kPolynomial>(Xb, sq_b, V, len, out, P, m_pad, d,
                                          degree, gamma, coef0, stream);
        case kRbf:
            return launch<T, kRbf>(Xb, sq_b, V, len, out, P, m_pad, d, degree,
                                   gamma, coef0, stream);
        case kSigmoid:
            return launch<T, kSigmoid>(Xb, sq_b, V, len, out, P, m_pad, d,
                                       degree, gamma, coef0, stream);
        case kLaplacian:
            return launch<T, kLaplacian>(Xb, sq_b, V, len, out, P, m_pad, d,
                                         degree, gamma, coef0, stream);
        case kChiSquared:
            return launch<T, kChiSquared>(Xb, sq_b, V, len, out, P, m_pad, d,
                                          degree, gamma, coef0, stream);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// The C interface: every entry point returns the cudaError_t of its launch
// (0 on success).  kind is KernelFunctionType's value (1 polynomial, 2 RBF,
// 3 sigmoid, 4 laplacian, 5 chi-squared; not 0, linear); sq_b may be null
// for the distance kinds; len (P,) int64 on the device, each <= m_pad; out
// must hold zeros: rows past len[p] are not written.

extern "C" int plssvm_pairs_matvec_f32(const float* Xb, const float* sq_b,
                                       const float* V, const int64_t* len,
                                       float* out, int64_t P, int64_t m_pad,
                                       int64_t d, int kind, int degree,
                                       float gamma, float coef0,
                                       void* stream) {
    return pairs<float>(Xb, sq_b, V, len, out, P, m_pad, d, kind, degree,
                        gamma, coef0, stream);
}

extern "C" int plssvm_pairs_matvec_f64(const double* Xb, const double* sq_b,
                                       const double* V, const int64_t* len,
                                       double* out, int64_t P, int64_t m_pad,
                                       int64_t d, int kind, int degree,
                                       double gamma, double coef0,
                                       void* stream) {
    return pairs<double>(Xb, sq_b, V, len, out, P, m_pad, d, kind, degree,
                         gamma, coef0, stream);
}
