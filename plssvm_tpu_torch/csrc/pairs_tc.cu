// Kernel O on the tensor cores: the batched pair-machine matvec of
// one-vs-one training for the Gram kinds (polynomial, RBF, sigmoid), written
// by hand for NVIDIA Hopper (sm_90a), in two walks:
//
// - float32 at the tiers "f32" (TF32 operands) and "bf16" (bf16 operands),
//   f32 accumulation: wgmma m64n128 in two warpgroups, from the rect
//   tensor-core tile's pieces (gram_tc.cuh: the TMA 3-stage ring and its box
//   stream tc_consume, the accumulator fragment TcFragment, the kernel
//   values tc_kernel_fragment, the per-thread row sums tc_row_sums);
// - float64 at every tier: mma.sync m16n8k4 f64 in eight warps, from the
//   rect DMMA tile's pieces (gram_dmma.cuh: the 4-stage ring and its box
//   stream dmma_consume, dmma_kernel_values, dmma_row_partials).
//
//   out[p, i] = sum_{j < len[p]} k(Xb[p, i], Xb[p, j]) * V[p, j]  for i < len[p]
//
// as pairs.cu's FFMA walk computes it (ops/pairs.py routes by kind, tier
// and type; laplacian, chi-squared and "highest" take pairs.cu).  It
// replaces no Pallas kernel: plssvm_tpu computes this product in XLA,
// kernel_block's dot_general without a precision argument
// (plssvm_tpu/kernel_functions.py:285-291, through _make_kernel_matvec at
// plssvm_tpu/solver/cg.py:1104), which on the TPU is one bf16 MXU pass,
// the reference's "f32" tier; so the batched solve runs at the fit's
// gram_precision, as every other product of a solve does.
//
// The walk: one block owns a 128-row tile of one machine (blockIdx.x the
// tile, blockIdx.y the machine, P <= 65535) and walks every column tile of
// that machine in one stream of boxes, so the next tile's first boxes load
// during this tile's epilogue.  A block whose tile starts at or past len[p]
// exits at once.  One 2-D tensor map covers the whole (P m_pad, d_pad)
// operand copy; machine p's tiles start at row p m_pad + 128 t, so a box
// that runs past len[p] reads machine p + 1's rows (or the map's zero fill
// past the last machine): the epilogue makes every kernel value of a row or
// column at or past len[p] exactly 0 and stores no such row.  Each row of a
// tile belongs to one quad of one warpgroup (TF32 / bf16) or to one thread
// after a fixed reduction over the four warps across (float64), which adds
// the tile's row sums to a running sum in tile order and stores the total
// once after the last tile.  No atomics: every output is written once, in
// an order fixed by the machine's own length, so two launches on the same
// input are bit for bit the same and a machine's output does not depend on
// P, on m_pad or on its neighbours (the machine split's float32 bit-identity
// rests on it).  Offsets into the stack are 64-bit; TMA's coordinates are
// 32-bit, so P m_pad + 128 must fit an int.
//
// What bounds it on an H100: the pair work, 2 sum_p len[p]^2 d flops as
// walked (the bound counts the sum_p len[p] (len[p] + 1) / 2 distinct
// pairs, so the full square reaches at most half of it), at 495 TFLOP/s
// (TF32), 989 (bf16) or 67 (DMMA); beside it the epilogue's exp (RBF) per
// pair and one FFMA per pair.  The operand copy (the wrapper's
// tier_operand / dmma_operand of the stack, made once per solve) is read
// once per block, from L2 mostly: a machine's rows are a few MB.

#include "gram_dmma.cuh"

namespace {

// out[p, r] = sum_j k(x_r, x_j) V[p, j] over row tile blockIdx.x of
// machine p = blockIdx.y and every column tile of it; the stack arrives
// through xmap as the tier's operand copy ((P m_pad) rows, d_pad features),
// nk boxes of features per tile; sq_b the float32 stack's squared norms.
template <typename Tier, int KIND>
__global__ void __launch_bounds__(kTcThreads, 2)
    pairs_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                    const float* __restrict__ sq_b,
                    const float* __restrict__ V,
                    const int64_t* __restrict__ len, float* __restrict__ out,
                    int64_t m_pad, int nk, int degree, float gamma,
                    float coef0) {
    extern __shared__ uint8_t tc_ring[];
    __shared__ __align__(8) uint64_t full[kTcStages];
    __shared__ __align__(8) uint64_t empty[kTcStages];
    __shared__ float sq_r[kTcEdge];
    // the column tile's norms and V, alternating between tiles: one barrier
    // a tile
    __shared__ float sq_c[2][kTcEdge];
    __shared__ float v_c[2][kTcEdge];

    const int64_t base = static_cast<int64_t>(blockIdx.y) * m_pad;
    const int m = static_cast<int>(len[blockIdx.y]);
    const int row0 = static_cast<int>(blockIdx.x) * kTcEdge;
    if (row0 >= m) {  // uniform per block
        return;
    }
    const float* sq = sq_b + base;
    const float* v = V + base;
    const int total = ((m + kTcEdge - 1) / kTcEdge) * nk;
    const int tid = threadIdx.x;
    const uint32_t ring = (smem_address(tc_ring) + 1023u) & ~1023u;

    if (tid == 0) {
        tc_init_barriers(full, empty);
    }
    if (tid < kTcEdge) {
        const int r = row0 + tid;
        sq_r[tid] = r < m ? sq[r] : 0.0f;
    }
    __syncthreads();

    // stage s <- box g of the stream: feature box g % nk of the row tile and
    // of column tile g / nk, rows counted from the stack's first
    const int map_base = static_cast<int>(base);
    auto load = [&](int g, int s) {
        const uint32_t bar = smem_address(&full[s]);
        const uint32_t dst = ring + s * kTcStageBytes;
        const int feature = (g % nk) * Tier::kFeatures;
        mbar_expect_tx(bar, kTcStageBytes);
        tma_load(dst, &xmap, bar, feature, map_base + row0);
        tma_load(dst + kTcOperandBytes, &xmap, bar, feature,
                 map_base + (g / nk) * kTcEdge);
    };
    if (tid == 0) {
        for (int s = 0; s < kTcStages && s < total; ++s) {
            load(s, s);
        }
    }

    const TcFragment f(tid);
    const bool row_ok[2] = {row0 + f.rl[0] < m, row0 + f.rl[1] < m};
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) {
        acc[i] = 0.0f;
    }
    float run[2] = {0.0f, 0.0f};
    for (int g = 0; g < total; ++g) {
        // a tile's first box overwrites the accumulators (scale-d 0)
        tc_consume<Tier>(acc, ring, full, empty, g, total, tid, g % nk != 0,
                         load);
        if (g % nk != nk - 1) {
            continue;
        }
        // the tile's last box: its epilogue, while the next tile's first
        // boxes load.  The readers of this buffer two tiles ago finished
        // before the previous tile's barrier.
        wgmma_wait<0>();
        fence_acc(acc);
        const int jt = g / nk;
        const int col0 = jt * kTcEdge;
        const int buf = jt & 1;
        if (tid < kTcEdge) {
            const int c = col0 + tid;
            sq_c[buf][tid] = c < m ? sq[c] : 0.0f;
        } else {
            const int c = col0 + tid - kTcEdge;
            v_c[buf][tid - kTcEdge] = c < m ? v[c] : 0.0f;
        }
        __syncthreads();
        tc_kernel_fragment<KIND>(acc, f, row_ok, sq_r, sq_c[buf], col0, m,
                                 degree, gamma, coef0);
        float rs[2];
        tc_row_sums(acc, v_c[buf], f.q, rs);
        run[0] += rs[0];
        run[1] += rs[1];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        if (f.q == 0 && row_ok[h]) {
            out[base + row0 + f.rl[h]] = run[h];
        }
    }
}

// The float64 walk: out[p, r] as above on the DMMA product, the stack
// arriving through xmap as dmma_operand's copy (d_pad even).  Warp (wm, wn)
// holds rows wm * 64 .. + 64 against columns wn * 32 .. + 32 of a tile;
// thread r < 128 adds row r's four partials, in a fixed order, to its
// running sum.
template <int KIND>
__global__ void __launch_bounds__(kDmThreads, 1)
    pairs_dmma_kernel(const __grid_constant__ CUtensorMap xmap,
                      const double* __restrict__ sq_b,
                      const double* __restrict__ V,
                      const int64_t* __restrict__ len,
                      double* __restrict__ out, int64_t m_pad, int nk,
                      int degree, double gamma, double coef0) {
    extern __shared__ uint8_t dm_ring[];
    __shared__ __align__(8) uint64_t full[kDmStages];
    __shared__ __align__(8) uint64_t empty[kDmStages];
    __shared__ double sq_rows[kDmEdge];
    // the column tile's norms and V, and the row partials, alternating
    // between tiles
    __shared__ double sq_cols[2][kDmEdge];
    __shared__ double v_cols[2][kDmEdge];
    __shared__ double row_part[2][4][kDmEdge];  // [tile parity][warp across]

    const int64_t base = static_cast<int64_t>(blockIdx.y) * m_pad;
    const int m = static_cast<int>(len[blockIdx.y]);
    const int row0 = static_cast<int>(blockIdx.x) * kDmEdge;
    if (row0 >= m) {  // uniform per block
        return;
    }
    const double* sq = sq_b + base;
    const double* v = V + base;
    const int total = ((m + kDmEdge - 1) / kDmEdge) * nk;
    const int tid = threadIdx.x;
    const uint32_t ring_offset =
        ((smem_address(dm_ring) + 1023u) & ~1023u) - smem_address(dm_ring);
    const uint32_t ring = smem_address(dm_ring) + ring_offset;
    const uint8_t* ring_ptr = dm_ring + ring_offset;

    if (tid == 0) {
        for (int s = 0; s < kDmStages; ++s) {
            mbar_init(smem_address(&full[s]), 1);
            mbar_init(smem_address(&empty[s]), kDmThreads);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    if (tid < kDmEdge) {
        const int r = row0 + tid;
        sq_rows[tid] = r < m ? sq[r] : 0.0;
    }
    __syncthreads();

    // stage s <- box k of the stream: feature box k % nk of the row tile and
    // of column tile k / nk, rows counted from the stack's first
    const int map_base = static_cast<int>(base);
    auto load = [&](int k, int s) {
        const uint32_t bar = smem_address(&full[s]);
        const uint32_t dst = ring + s * kDmStageBytes;
        const int feature = (k % nk) * kDmFeatures;
        mbar_expect_tx(bar, kDmStageBytes);
        tma_load(dst, &xmap, bar, feature, map_base + row0);
        tma_load(dst + kDmOperandBytes, &xmap, bar, feature,
                 map_base + (k / nk) * kDmEdge);
    };
    if (tid == 0) {
        for (int s = 0; s < kDmStages && s < total; ++s) {
            load(s, s);
        }
    }

    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int wm = warp / 4;  // rows wm * 64 .. + 64 of the tile
    const int wn = warp % 4;  // columns wn * 32 .. + 32
    double acc[4][4][4];
    double run = 0.0;  // row tid's sum (tid < kDmEdge)
    for (int jt = 0; jt < total / nk; ++jt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int n = 0; n < 4; ++n) {
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    acc[i][n][q] = 0.0;
                }
            }
        }
        for (int k = jt * nk; k < (jt + 1) * nk; ++k) {
            dmma_consume(acc, ring_ptr, full, empty, k, total, tid, wm, wn, g, t,
                         load);
        }
        // the tile's epilogue, while the next tile's first boxes load; the
        // readers of this parity's buffers two tiles ago finished before
        // the previous tile's barriers
        const int col0 = jt * kDmEdge;
        const int buf = jt & 1;
        if (tid < kDmEdge) {
            const int c = col0 + tid;
            sq_cols[buf][tid] = c < m ? sq[c] : 0.0;
        } else {
            const int c = col0 + tid - kDmEdge;
            v_cols[buf][tid - kDmEdge] = c < m ? v[c] : 0.0;
        }
        __syncthreads();
        dmma_kernel_values<KIND>(acc, sq_rows, sq_cols[buf], row0, col0, m, m,
                                 wm, wn, g, t, degree, gamma, coef0);
        dmma_row_partials(acc, v_cols[buf], wm, wn, g, t, row_part[buf][wn]);
        __syncthreads();
        if (tid < kDmEdge) {
            run += (row_part[buf][0][tid] + row_part[buf][1][tid]) +
                   (row_part[buf][2][tid] + row_part[buf][3][tid]);
        }
    }
    if (tid < kDmEdge && row0 + tid < m) {
        out[base + row0 + tid] = run;
    }
}

static_assert(kTcEdge == kDmEdge, "both walks take 128-row tiles");

// What the walks take of a stack: P in [1, 65535], 32-bit TMA coordinates
// past its last row, the stream's box count an int, the operand as TMA
// reads it.
template <typename Operand>
bool pairs_shape_ok(const void* Xop, int64_t P, int64_t m_pad, int64_t d_pad,
                    int64_t nk) {
    const int64_t rows = P * m_pad;
    return P > 0 && P <= 65535 && m_pad > 0 && nk > 0 &&
           rows + kTcEdge <= INT32_MAX &&
           ((m_pad + kTcEdge - 1) / kTcEdge) * nk <= INT32_MAX &&
           tma_operand_ok<Operand>(Xop, rows, d_pad);
}

template <typename Tier, int KIND>
cudaError_t launch_pairs_tc(const void* Xop, const float* sq_b, const float* V,
                            const int64_t* len, float* out, int64_t P,
                            int64_t m_pad, int64_t d_pad, int degree,
                            float gamma, float coef0, cudaStream_t stream) {
    const int64_t nk = (d_pad + Tier::kFeatures - 1) / Tier::kFeatures;
    if (!pairs_shape_ok<Tier>(Xop, P, m_pad, d_pad, nk)) {
        return cudaErrorInvalidValue;
    }
    CUtensorMap map;
    cudaError_t err = encode_operand<Tier>(&map, Xop, P * m_pad, d_pad);
    if (err != cudaSuccess) {
        return err;
    }
    auto kernel = pairs_tc_kernel<Tier, KIND>;
    err = tc_allow_ring(kernel);
    if (err != cudaSuccess) {
        return err;
    }
    const dim3 grid(static_cast<unsigned int>((m_pad + kTcEdge - 1) / kTcEdge),
                    static_cast<unsigned int>(P));
    kernel<<<grid, kTcThreads, kTcSmemBytes, stream>>>(
        map, sq_b, V, len, out, m_pad, static_cast<int>(nk), degree, gamma,
        coef0);
    return cudaGetLastError();
}

template <int KIND>
cudaError_t launch_pairs_dmma(const double* Xop, const double* sq_b,
                              const double* V, const int64_t* len, double* out,
                              int64_t P, int64_t m_pad, int64_t d_pad,
                              int degree, double gamma, double coef0,
                              cudaStream_t stream) {
    const int64_t nk = (d_pad + kDmFeatures - 1) / kDmFeatures;
    if (!pairs_shape_ok<F64Operand>(Xop, P, m_pad, d_pad, nk)) {
        return cudaErrorInvalidValue;
    }
    CUtensorMap map;
    cudaError_t err = encode_operand<F64Operand>(&map, Xop, P * m_pad, d_pad);
    if (err != cudaSuccess) {
        return err;
    }
    auto kernel = pairs_dmma_kernel<KIND>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kDmSmemBytes);
    if (err != cudaSuccess) {
        return err;
    }
    const dim3 grid(static_cast<unsigned int>((m_pad + kDmEdge - 1) / kDmEdge),
                    static_cast<unsigned int>(P));
    kernel<<<grid, kDmThreads, kDmSmemBytes, stream>>>(
        map, sq_b, V, len, out, m_pad, static_cast<int>(nk), degree, gamma,
        coef0);
    return cudaGetLastError();
}

template <typename Tier>
int pairs_tc(const void* Xop, const float* sq_b, const float* V,
             const int64_t* len, float* out, int64_t P, int64_t m_pad,
             int64_t d_pad, int kind, int degree, float gamma, float coef0,
             void* stream) {
    return tc_dispatch_kind<Tier>(kind, [&](auto tier, auto k) {
        return static_cast<int>(launch_pairs_tc<decltype(tier), decltype(k)::value>(
            Xop, sq_b, V, len, out, P, m_pad, d_pad, degree, gamma, coef0,
            static_cast<cudaStream_t>(stream)));
    });
}

}  // namespace

// The C interface: every entry point returns the cudaError_t of its launch
// (0 on success).  kind is KernelFunctionType's value (1 polynomial, 2 RBF,
// 3 sigmoid); Xop the tier's operand copy of the (P, m_pad, d) stack as
// (P m_pad, d_pad) rows, 16-byte aligned, d_pad a multiple of 4 (TF32), 8
// (bf16) or 2 (float64); sq_b (P, m_pad) the squared norms of the
// unrounded stack; V and out (P, m_pad); len (P,) int64 on the device, each
// <= m_pad; out must hold zeros: rows past len[p] are not written.

extern "C" int plssvm_pairs_matvec_tf32(const void* Xop, const float* sq_b,
                                        const float* V, const int64_t* len,
                                        float* out, int64_t P, int64_t m_pad,
                                        int64_t d_pad, int kind, int degree,
                                        float gamma, float coef0,
                                        void* stream) {
    return pairs_tc<Tf32Tier>(Xop, sq_b, V, len, out, P, m_pad, d_pad, kind,
                              degree, gamma, coef0, stream);
}

extern "C" int plssvm_pairs_matvec_bf16(const void* Xop, const float* sq_b,
                                        const float* V, const int64_t* len,
                                        float* out, int64_t P, int64_t m_pad,
                                        int64_t d_pad, int kind, int degree,
                                        float gamma, float coef0,
                                        void* stream) {
    return pairs_tc<Bf16Tier>(Xop, sq_b, V, len, out, P, m_pad, d_pad, kind,
                              degree, gamma, coef0, stream);
}

extern "C" int plssvm_pairs_matvec_dmma(const double* Xop, const double* sq_b,
                                        const double* V, const int64_t* len,
                                        double* out, int64_t P, int64_t m_pad,
                                        int64_t d_pad, int kind, int degree,
                                        double gamma, double coef0,
                                        void* stream) {
    return dmma_dispatch(kind, [&](auto k) {
        return static_cast<int>(launch_pairs_dmma<decltype(k)::value>(
            Xop, sq_b, V, len, out, P, m_pad, d_pad, degree, gamma, coef0,
            static_cast<cudaStream_t>(stream)));
    });
}

// How many blocks of a walk an SM holds at once for the kernel function
// ``kind``: walk 0 the TF32 one, 1 the bf16 one (both designed for two), 2
// the float64 one (designed for one).
extern "C" int plssvm_pairs_blocks_per_sm(int walk, int kind, int* blocks) {
    if (walk == 2) {
        return dmma_dispatch(kind, [&](auto k) {
            auto kernel = pairs_dmma_kernel<decltype(k)::value>;
            cudaError_t err = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDmSmemBytes);
            if (err == cudaSuccess) {
                err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    blocks, kernel, kDmThreads, kDmSmemBytes);
            }
            return static_cast<int>(err);
        });
    }
    if (walk != 0 && walk != 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return tc_dispatch(walk == 1, kind, [&](auto tier, auto k) {
        auto kernel = pairs_tc_kernel<decltype(tier), decltype(k)::value>;
        cudaError_t err = tc_allow_ring(kernel);
        if (err == cudaSuccess) {
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                blocks, kernel, kTcThreads, kTcSmemBytes);
        }
        return static_cast<int>(err);
    });
}
