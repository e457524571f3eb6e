// The dual walks of one kernel block, K(Xr, Xc) contracted both ways, for
// the row-sharded ring (plssvm_tpu_torch/parallel/sharded.py), written by
// hand for NVIDIA Hopper (sm_90a).  Bound to PyTorch through a plain C
// interface and ctypes (ops/gram_matvec.py, ops/gram_matmat.py,
// ops/distance.py); built by ops/_build.py.
//
// Each kernel returns out_r = K(Xr, Xc) @ v_c and out_c = K(Xr, Xc)^T @ v_r
// for one off-diagonal block of the ring: Xr (mr, d) the shard's own rows,
// Xc (mc, d) the rows it received, any mr, mc, d >= 1.
//
// Kernel J, gram_matvec_dual: replaces plssvm_tpu/ops/pallas_matvec.py
//   kernel_matvec_pallas_dual (body _matvec_kernel_dual) with
//   symmetric=False, the ring's cross_dual (plssvm_tpu/parallel/sharded.py
//   ring_kernel_matvec).  Polynomial, RBF, sigmoid.
// Kernel K, gram_matmat_dual: replaces kernel_matmat_pallas_dual (body
//   _matmat_kernel_dual) with symmetric=False, ring_kernel_matmat's
//   cross_dual: V_c (mc, C) and V_r (mr, C) row-major.
// Kernel L, distance_matvec_dual: replaces plssvm_tpu/ops/pallas_distance.py
//   distance_matvec_pallas_dual (body _distance_kernel_dual) with
//   symmetric=False.  Laplacian, chi-squared.
// Kernel M, distance_matmat_dual: replaces distance_matmat_pallas_dual (body
//   _distance_kernel_matmat_dual) with symmetric=False.
//
// The walk is kernel B's 2-D grid over EVERY BM x BM tile of the mr x mc
// block (row tiles x column tiles, one linear index, consecutive blocks on
// one row tile), not kernel A's upper triangle: the block is not symmetric.
// The tile is the FFMA register tile of gram_tile.cuh with the pair
// operation of the kind (the Gram product, or kernels E-H's laplacian and
// chi-squared terms with their per-type edge, unroll and chunk sums, so the
// per-entry error of float chi-squared is kernel G's).  The epilogue is
// kernel A's (gram_matvec.cu): row sums through half_warp_sum and one
// atomicAdd per row into out_r, column sums through col_part and one
// atomicAdd per column into out_c, here for every tile.  J and L fuse the
// epilogue into both contractions; K and M turn the tile into kernel values
// first and loop over the classes (dual_class_loop: kernel C's class loop
// with both directions always on, and separate row and column bounds).
// Both edges are masked, so nothing is padded; sizes are 64-bit.  Not
// carried over from the TPU: the 128-row padding, the class-major layout
// padded to 8, the resident column accumulator (atomics replace it).
//
// Tiers: the Gram walks here serve J and K in float32 at "highest" (L and
// M serve every tier and both types).  On float32 data at "f32" (TF32) and
// "bf16", J and K run on the dual tensor-core tile of gram_tc.cuh
// (gram_tc_dual_kernel, instantiated here behind
// plssvm_gram_matvec_dual_tc_* / plssvm_gram_matmat_dual_tc_*), which takes
// the wrapper's operand copies of Xr and Xc (tier_operand) with the float32
// operands' norms; every product of a ring solve stays at its one tier.  In
// float64, at every tier, J and K run on the dual DMMA tile of
// gram_dmma.cu, as the ring's symmetric products (kernels A and C) run on
// its symmetric one, so the Gram walks here are compiled for float32 only.
//
// What bounds them: as kernels A-H, the pair operation on the CUDA cores,
// mr * mc * d pair evaluations (all of them, where A and E evaluate half
// the square), on the FP32 lanes (Gram, laplacian), the SFU (float
// chi-squared) or the FP64 pipe (float64 distances: chi-squared's
// divide-free quotient of ChiSquaredDistance, in gram_tile.cuh, on chunks
// whose values pass its guard).  The column sums cost one atomic per column and tile (per
// class in K and M) where A pays them off the diagonal only.
//
// Numerics: no fast-math, as kernels A-H.  The atomics make the summation
// order change from run to run.

#include <type_traits>

#include "gram_tc.cuh"

namespace {

template <int KIND>
constexpr bool kIsDistance = KIND == kLaplacian || KIND == kChiSquared;

// The pair operation and tile edge of kind KIND on T: the Gram product on
// the Gram tile edge, or the distance term on its own edge.
template <typename T, int KIND, bool = kIsDistance<KIND>>
struct Dual {
    using Op = GramProduct;
    static constexpr int kEdge = TileEdge<T>::value;
};
template <typename T, int KIND>
struct Dual<T, KIND, true> {
    using Op = typename DistanceOp<KIND>::type;
    static constexpr int kEdge = kDistanceEdge<T, KIND>;
};

// k(x_i, y_j) from the tile's sum: the Gram epilogue, or exp(-gamma * acc).
template <typename T, int KIND>
__device__ __forceinline__ T dual_value(T acc, T sq_i, T sq_j, T gamma,
                                        T coef0, int degree) {
    if constexpr (kIsDistance<KIND>) {
        return dev_exp(-gamma * acc);
    } else {
        return apply_kernel<T, KIND>(acc, sq_i, sq_j, gamma, coef0, degree);
    }
}

template <typename T, int KIND>
__global__ void __launch_bounds__(kThreads * kThreads)
    matvec_dual_kernel(const T* __restrict__ Xr, const T* __restrict__ Xc,
                       const T* __restrict__ sq_r, const T* __restrict__ sq_c,
                       const T* __restrict__ v_c, const T* __restrict__ v_r,
                       T* __restrict__ out_r, T* __restrict__ out_c,
                       int64_t mr, int64_t mc, int64_t d, int64_t n_ctiles,
                       int degree, T gamma, T coef0) {
    constexpr int BM = Dual<T, KIND>::kEdge;
    constexpr int R = BM / kThreads;
    __shared__ Staging<T, BM> staging;
    __shared__ T col_part[kThreads][BM];

    const int64_t p = blockIdx.x;
    const int64_t row0 = (p / n_ctiles) * BM;
    const int64_t col0 = (p % n_ctiles) * BM;

    T acc[R][R];
    gram_tile<T, BM, typename Dual<T, KIND>::Op>(Xr, Xc, mr, mc, d, row0,
                                                  col0, staging, acc);

    const int tx = threadIdx.x;
    const int ty = threadIdx.y;
    bool row_ok[R];
    bool col_ok[R];
    T sq_a[R], w_r[R], sq_b[R], w_c[R];
#pragma unroll
    for (int a = 0; a < R; ++a) {
        const int64_t r = row0 + ty + kThreads * a;
        row_ok[a] = r < mr;
        sq_a[a] = T(0);
        if constexpr (!kIsDistance<KIND>) {
            sq_a[a] = row_ok[a] ? sq_r[r] : T(0);
        }
        w_r[a] = row_ok[a] ? v_r[r] : T(0);
    }
#pragma unroll
    for (int b = 0; b < R; ++b) {
        const int64_t c = col0 + tx + kThreads * b;
        col_ok[b] = c < mc;
        sq_b[b] = T(0);
        if constexpr (!kIsDistance<KIND>) {
            sq_b[b] = col_ok[b] ? sq_c[c] : T(0);
        }
        w_c[b] = col_ok[b] ? v_c[c] : T(0);
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
                ? dual_value<T, KIND>(acc[a][b], sq_a[a], sq_b[b], gamma,
                                      coef0, degree)
                : T(0);
            row_sum[a] += kval * w_c[b];
            col_sum[b] += kval * w_r[a];
        }
    }
#pragma unroll
    for (int a = 0; a < R; ++a) {
        const T total = half_warp_sum(row_sum[a]);
        if (tx == 0 && row_ok[a]) {
            atomicAdd(&out_r[row0 + ty + kThreads * a], total);
        }
    }
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
        if (col0 + c < mc) {
            atomicAdd(&out_c[col0 + c], total);
        }
    }
}

// The class loop of the dual block matmats (kernels K and M): with the
// kernel tile kv in registers, out_r[r, c] += sum_j kv[r][j] Vc[j, c] for
// the tile's rows and out_c[j, c] += sum_r kv[r][j] Vr[r, c] for its
// columns, for every class c.  Vc (mc, C), Vr (mr, C), out_r (mr, C) and
// out_c (mc, C) are row-major; the V rows of both tiles are staged
// kClassChunk classes at a time in v_cols / v_rows, the column partials
// reduced through col_part.  Kernel C's sym_class_loop with the column sums
// on for every tile and the row and column bounds apart.
template <typename T, int BM>
__device__ __forceinline__ void dual_class_loop(
    const T (&kv)[BM / kThreads][BM / kThreads], const T* __restrict__ Vc,
    const T* __restrict__ Vr, T* __restrict__ out_r, T* __restrict__ out_c,
    int64_t mr, int64_t mc, int64_t C, int64_t row0, int64_t col0,
    T (*v_cols)[BM + 1], T (*v_rows)[BM + 1], T (*col_part)[BM]) {
    constexpr int R = BM / kThreads;
    const int tx = threadIdx.x;
    const int ty = threadIdx.y;
    const int tid = ty * kThreads + tx;
    for (int64_t c0 = 0; c0 < C; c0 += kClassChunk) {
        const int cn = static_cast<int>(
            C - c0 < kClassChunk ? C - c0 : kClassChunk);
        __syncthreads();  // the previous chunk's readers are done
        stage_classes<T, BM>(Vc, mc, C, col0, c0, cn, v_cols);
        stage_classes<T, BM>(Vr, mr, C, row0, c0, cn, v_rows);
        __syncthreads();
        for (int cc = 0; cc < cn; ++cc) {
            const int64_t c = c0 + cc;
            T vc[R];
            T vr[R];
#pragma unroll
            for (int b = 0; b < R; ++b) {
                vc[b] = v_cols[cc][tx + kThreads * b];
            }
#pragma unroll
            for (int a = 0; a < R; ++a) {
                vr[a] = v_rows[cc][ty + kThreads * a];
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
                if (tx == 0 && r < mr) {
                    atomicAdd(&out_r[r * C + c], total);
                }
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
                if (col0 + j < mc) {
                    atomicAdd(&out_c[(col0 + j) * C + c], total);
                }
            }
            __syncthreads();  // col_part is written again next class
        }
    }
}

template <typename T, int KIND>
__global__ void __launch_bounds__(kThreads * kThreads)
    matmat_dual_kernel(const T* __restrict__ Xr, const T* __restrict__ Xc,
                       const T* __restrict__ sq_r, const T* __restrict__ sq_c,
                       const T* __restrict__ Vc, const T* __restrict__ Vr,
                       T* __restrict__ out_r, T* __restrict__ out_c,
                       int64_t mr, int64_t mc, int64_t d, int64_t C,
                       int64_t n_ctiles, int degree, T gamma, T coef0) {
    constexpr int BM = Dual<T, KIND>::kEdge;
    constexpr int R = BM / kThreads;
    __shared__ Staging<T, BM> staging;
    __shared__ T v_cols[kClassChunk][BM + 1];  // Vc rows of the column tile
    __shared__ T v_rows[kClassChunk][BM + 1];  // Vr rows of the row tile
    __shared__ T col_part[kThreads][BM];

    const int64_t p = blockIdx.x;
    const int64_t row0 = (p / n_ctiles) * BM;
    const int64_t col0 = (p % n_ctiles) * BM;

    T kv[R][R];
    gram_tile<T, BM, typename Dual<T, KIND>::Op>(Xr, Xc, mr, mc, d, row0,
                                                  col0, staging, kv);
    if constexpr (kIsDistance<KIND>) {
        distance_kernel_tile<T, BM>(kv, mr, mc, row0, col0, gamma);
    } else {
        kernel_tile<T, KIND, BM>(kv, sq_r, sq_c, mr, mc, row0, col0, degree,
                                 gamma, coef0);
    }
    dual_class_loop<T, BM>(kv, Vc, Vr, out_r, out_c, mr, mc, C, row0, col0,
                           v_cols, v_rows, col_part);
}

// launch(std::integral_constant<int, KIND>) for a runtime kind of the
// family: the Gram kinds (polynomial, RBF, sigmoid) or the distance kinds.
template <bool kDistance, typename Launch>
int by_kind(int kind, Launch&& launch) {
    if constexpr (kDistance) {
        switch (kind) {
            case kLaplacian:
                return launch(std::integral_constant<int, kLaplacian>{});
            case kChiSquared:
                return launch(std::integral_constant<int, kChiSquared>{});
            default:
                return cudaErrorInvalidValue;
        }
    } else {
        switch (kind) {
            case kPolynomial:
                return launch(std::integral_constant<int, kPolynomial>{});
            case kRbf:
                return launch(std::integral_constant<int, kRbf>{});
            case kSigmoid:
                return launch(std::integral_constant<int, kSigmoid>{});
            default:
                return cudaErrorInvalidValue;
        }
    }
}

// Blocks of the full walk over an mr x mc block in BM x BM tiles, 0 when
// they do not fit a 1-D grid; n_ctiles the column tiles per row tile.
template <int BM>
unsigned int block_tiles(int64_t mr, int64_t mc, int64_t& n_ctiles) {
    n_ctiles = (mc + BM - 1) / BM;
    const int64_t blocks = ((mr + BM - 1) / BM) * n_ctiles;
    return blocks <= 0 || blocks > INT32_MAX ? 0u
                                             : static_cast<unsigned int>(blocks);
}

template <typename T, bool kDistance>
int matvec_dual(const T* Xr, const T* Xc, const T* sq_r,
                const T* sq_c, const T* v_c, const T* v_r, T* out_r,
                T* out_c, int64_t mr, int64_t mc, int64_t d, int kind,
                int degree, T gamma, T coef0, void* stream) {
    return by_kind<kDistance>(kind, [&](auto k) {
        constexpr int KIND = decltype(k)::value;
        int64_t n_ctiles = 0;
        const unsigned int blocks =
            block_tiles<Dual<T, KIND>::kEdge>(mr, mc, n_ctiles);
        if (blocks == 0) {
            return static_cast<int>(cudaErrorInvalidValue);
        }
        matvec_dual_kernel<T, KIND>
            <<<blocks, dim3(kThreads, kThreads), 0,
               static_cast<cudaStream_t>(stream)>>>(
                Xr, Xc, sq_r, sq_c, v_c, v_r, out_r, out_c, mr, mc, d,
                n_ctiles, degree, gamma, coef0);
        return static_cast<int>(cudaGetLastError());
    });
}

template <typename T, bool kDistance>
int matmat_dual(const T* Xr, const T* Xc, const T* sq_r,
                const T* sq_c, const T* Vc, const T* Vr, T* out_r, T* out_c,
                int64_t mr, int64_t mc, int64_t d, int64_t C, int kind,
                int degree, T gamma, T coef0, void* stream) {
    return by_kind<kDistance>(kind, [&](auto k) {
        constexpr int KIND = decltype(k)::value;
        int64_t n_ctiles = 0;
        const unsigned int blocks =
            block_tiles<Dual<T, KIND>::kEdge>(mr, mc, n_ctiles);
        if (blocks == 0 || C <= 0) {
            return static_cast<int>(cudaErrorInvalidValue);
        }
        matmat_dual_kernel<T, KIND>
            <<<blocks, dim3(kThreads, kThreads), 0,
               static_cast<cudaStream_t>(stream)>>>(
                Xr, Xc, sq_r, sq_c, Vc, Vr, out_r, out_c, mr, mc, d, C,
                n_ctiles, degree, gamma, coef0);
        return static_cast<int>(cudaGetLastError());
    });
}

}  // namespace

// The C interface: every entry point returns the cudaError_t of its launch
// (0 on success).  out_r (mr or mr x C) and out_c (mc or mc x C) must hold
// zeros: the kernels accumulate into them.  The Gram entry points take
// kind 1-3, the distance ones 4-5 (KernelFunctionType's values).

extern "C" int plssvm_gram_matvec_dual_f32(
    const float* Xr, const float* Xc, const float* sq_r, const float* sq_c,
    const float* v_c, const float* v_r, float* out_r, float* out_c,
    int64_t mr, int64_t mc, int64_t d, int kind, int degree, float gamma,
    float coef0, void* stream) {
    return matvec_dual<float, false>(Xr, Xc, sq_r, sq_c, v_c, v_r, out_r,
                                     out_c, mr, mc, d, kind, degree, gamma,
                                     coef0, stream);
}

extern "C" int plssvm_gram_matmat_dual_f32(
    const float* Xr, const float* Xc, const float* sq_r, const float* sq_c,
    const float* Vc, const float* Vr, float* out_r, float* out_c,
    int64_t mr, int64_t mc, int64_t d, int64_t C, int kind, int degree,
    float gamma, float coef0, void* stream) {
    return matmat_dual<float, false>(Xr, Xc, sq_r, sq_c, Vc, Vr, out_r,
                                     out_c, mr, mc, d, C, kind, degree, gamma,
                                     coef0, stream);
}

// The distance entry points take no squared norms.
extern "C" int plssvm_distance_matvec_dual_f32(
    const float* Xr, const float* Xc, const float* v_c, const float* v_r,
    float* out_r, float* out_c, int64_t mr, int64_t mc, int64_t d, int kind,
    float gamma, void* stream) {
    return matvec_dual<float, true>(Xr, Xc, nullptr, nullptr, v_c, v_r,
                                    out_r, out_c, mr, mc, d, kind, 0, gamma,
                                    0.0f, stream);
}

extern "C" int plssvm_distance_matvec_dual_f64(
    const double* Xr, const double* Xc, const double* v_c, const double* v_r,
    double* out_r, double* out_c, int64_t mr, int64_t mc, int64_t d,
    int kind, double gamma, void* stream) {
    return matvec_dual<double, true>(Xr, Xc, nullptr, nullptr, v_c, v_r,
                                     out_r, out_c, mr, mc, d, kind, 0, gamma,
                                     0.0, stream);
}

extern "C" int plssvm_distance_matmat_dual_f32(
    const float* Xr, const float* Xc, const float* Vc, const float* Vr,
    float* out_r, float* out_c, int64_t mr, int64_t mc, int64_t d, int64_t C,
    int kind, float gamma, void* stream) {
    return matmat_dual<float, true>(Xr, Xc, nullptr, nullptr, Vc, Vr, out_r,
                                    out_c, mr, mc, d, C, kind, 0, gamma, 0.0f,
                                    stream);
}

extern "C" int plssvm_distance_matmat_dual_f64(
    const double* Xr, const double* Xc, const double* Vc, const double* Vr,
    double* out_r, double* out_c, int64_t mr, int64_t mc, int64_t d,
    int64_t C, int kind, double gamma, void* stream) {
    return matmat_dual<double, true>(Xr, Xc, nullptr, nullptr, Vc, Vr, out_r,
                                     out_c, mr, mc, d, C, kind, 0, gamma, 0.0,
                                     stream);
}

// Kernels J and K on the dual tensor-core tile (gram_tc.cuh): Xr and Xc the
// tier's operand copies (mr, d_pad) and (mc, d_pad), TF32-rounded float32 or
// bf16; sq_r, sq_c the float32 operands' norms.
extern "C" int plssvm_gram_matvec_dual_tc_tf32(
    const void* Xr, const void* Xc, const float* sq_r, const float* sq_c,
    const float* v_c, const float* v_r, float* out_r, float* out_c,
    int64_t mr, int64_t mc, int64_t d_pad, int kind, int degree, float gamma,
    float coef0, void* stream) {
    return tc_dual<Tf32Tier>(Xr, Xc, sq_r, sq_c, v_c, v_r, out_r, out_c, mr, mc,
                             d_pad, 1, kind, degree, gamma, coef0, stream);
}

extern "C" int plssvm_gram_matvec_dual_tc_bf16(
    const void* Xr, const void* Xc, const float* sq_r, const float* sq_c,
    const float* v_c, const float* v_r, float* out_r, float* out_c,
    int64_t mr, int64_t mc, int64_t d_pad, int kind, int degree, float gamma,
    float coef0, void* stream) {
    return tc_dual<Bf16Tier>(Xr, Xc, sq_r, sq_c, v_c, v_r, out_r, out_c, mr, mc,
                             d_pad, 1, kind, degree, gamma, coef0, stream);
}

extern "C" int plssvm_gram_matmat_dual_tc_tf32(
    const void* Xr, const void* Xc, const float* sq_r, const float* sq_c,
    const float* Vc, const float* Vr, float* out_r, float* out_c,
    int64_t mr, int64_t mc, int64_t d_pad, int64_t C, int kind, int degree,
    float gamma, float coef0, void* stream) {
    return tc_dual<Tf32Tier>(Xr, Xc, sq_r, sq_c, Vc, Vr, out_r, out_c, mr, mc,
                             d_pad, C, kind, degree, gamma, coef0, stream);
}

extern "C" int plssvm_gram_matmat_dual_tc_bf16(
    const void* Xr, const void* Xc, const float* sq_r, const float* sq_c,
    const float* Vc, const float* Vr, float* out_r, float* out_c,
    int64_t mr, int64_t mc, int64_t d_pad, int64_t C, int kind, int degree,
    float gamma, float coef0, void* stream) {
    return tc_dual<Bf16Tier>(Xr, Xc, sq_r, sq_c, Vc, Vr, out_r, out_c, mr, mc,
                             d_pad, C, kind, degree, gamma, coef0, stream);
}

// Blocks of the dual tensor-core tile an SM holds at once, for the tier
// and kind, into *blocks; returns the query's cudaError_t.
extern "C" int plssvm_gram_dual_tc_blocks_per_sm(int bf16, int kind,
                                                 int* blocks) {
    return tc_dispatch(bf16 != 0, kind, [&](auto tier, auto k) {
        return static_cast<int>(
            tc_dual_blocks_per_sm<decltype(tier), decltype(k)::value>(*blocks));
    });
}
