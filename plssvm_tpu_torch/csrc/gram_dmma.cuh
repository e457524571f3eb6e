// The FP64 tensor-core (DMMA) tile's shared pieces: the ring's constants,
// the m16n8k4 product, the conflict-free fragment loads, the kernel values
// and the row and column partials, and the product loop.  gram_dmma.cu's
// note says how they are built; its tiles (kernels A-D, J and K in float64)
// and kernel O's float64 walk (pairs_tc.cu) are built from them.

#pragma once

#include "gram_tc.cuh"

namespace {

constexpr int kDmEdge = 128;                 // tile rows = tile columns
constexpr int kDmThreads = 256;              // 8 warps
constexpr int kDmStages = 4;                 // ring depth
constexpr int kDmFeatures = 16;              // doubles in a 128-byte box row
constexpr int kDmOperandBytes = kDmEdge * 128;          // one box, 16 KB
constexpr int kDmStageBytes = 2 * kDmOperandBytes;      // row and column box
constexpr int kDmSmemBytes = kDmStages * kDmStageBytes + 1024;  // + alignment

// The float64 operand for encode_operand / tma_operand_ok (gram_tc.cuh).
struct F64Operand {
    static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_FLOAT64;
    static constexpr int kItemSize = 8;
    static constexpr int kFeatures = kDmFeatures;
    static constexpr int kParts = 1;  // one part: encode_operand's 2-D map
};

// c += A B for A 16 x 4 (a0: row g, a1: row g + 8, column t) and B 4 x 8
// (b0: row t, column g); c0, c1 are row g, columns 2t and 2t + 1, c2, c3
// row g + 8.
__device__ __forceinline__ void dmma_16x8x4(double (&c)[4], double a0,
                                            double a1, double b0) {
    asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
        : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
        : "d"(a0), "d"(a1), "d"(b0));
}

// Product p (of four) of a 16-double box gives lane (g, t) the k position
// t = feature 2p + 8 (t / 2) + t % 2, which lies in 16-byte chunk p + 4 (t
// / 2), half t % 2; in the 128-byte swizzle that chunk of row r sits at
// slot chunk ^ (r % 8), and every row a lane loads has r % 8 = g.  The
// byte offset within the row:
__device__ __forceinline__ int dmma_offset(int t, int p, int g) {
    return (((p + 4 * (t / 2)) ^ g) << 4) + (t % 2) * 8;
}

// Row r's double at byte ``offset`` of the box at ``box`` (128-byte rows).
__device__ __forceinline__ double dmma_fragment(const uint8_t* box, int r,
                                                int offset) {
    return *reinterpret_cast<const double*>(box + r * 128 + offset);
}

// The products of one 16-double box of features: warp (wm, wn), lane (g,
// t), adds to acc[i][n] rows wm * 64 + 16 i of the row box xr against
// columns wn * 32 + 8 n of the column box xc.  acc[i][n][q] is row
// wm * 64 + 16 i + g + 8 (q / 2), column wn * 32 + 8 n + 2 t + q % 2.
__device__ __forceinline__ void dmma_box(double (&acc)[4][4][4],
                                         const uint8_t* xr, const uint8_t* xc,
                                         int wm, int wn, int g, int t) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
        // product p of the box: k position t is feature 2p + 8 (t / 2) +
        // t % 2 (dmma_offset)
        const int off = dmma_offset(t, p, g);
        double a0[4], a1[4], b0[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            a0[i] = dmma_fragment(xr, wm * 64 + 16 * i + g, off);
            a1[i] = dmma_fragment(xr, wm * 64 + 16 * i + 8 + g, off);
        }
#pragma unroll
        for (int n = 0; n < 4; ++n) {
            b0[n] = dmma_fragment(xc, wn * 32 + 8 * n + g, off);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int n = 0; n < 4; ++n) {
                dmma_16x8x4(acc[i][n], a0[i], a1[i], b0[n]);
            }
        }
    }
}

// In place: the Gram fragment becomes the kernel values, 0 outside the
// rows x cols matrix; sq_r / sq_c the tile's squared norms in shared
// memory, the tile at (row0, col0).
template <int KIND>
__device__ __forceinline__ void dmma_kernel_values(
    double (&acc)[4][4][4], const double* sq_r, const double* sq_c,
    int64_t row0, int64_t col0, int64_t rows, int64_t cols, int wm, int wn,
    int g, int t, int degree, double gamma, double coef0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int rl = wm * 64 + 16 * i + g + 8 * (q / 2);
            const bool row_ok = row0 + rl < rows;
#pragma unroll
            for (int n = 0; n < 4; ++n) {
                const int cl = wn * 32 + 8 * n + 2 * t + q % 2;
                double& kv = acc[i][n][q];
                kv = (row_ok && col0 + cl < cols)
                    ? apply_kernel<double, KIND>(kv, sq_r[rl], sq_c[cl], gamma,
                                                 coef0, degree)
                    : 0.0;
            }
        }
    }
}

// One class's row partials: sum over this warp's 32 columns of k(row, col)
// w[col], w the class's weights of the column tile; reduced over the four
// lanes of a row (a reduce-scatter: lane (g, t) keeps rows wm * 64 + 16 t +
// g + 8 u) into part[row], the warp-across column wn's partials.
__device__ __forceinline__ void dmma_row_partials(const double (&acc)[4][4][4],
                                                  const double* w, int wm,
                                                  int wn, int g, int t,
                                                  double* part) {
    const bool t1 = t & 2, t0 = t & 1;
    // rp[2 i + h] is row wm * 64 + 16 i + g + 8 h over this thread's eight
    // columns
    double rp[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            double sum = 0.0;
#pragma unroll
            for (int n = 0; n < 4; ++n) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    sum += acc[i][n][2 * h + e] * w[wn * 32 + 8 * n + 2 * t + e];
                }
            }
            rp[2 * i + h] = sum;
        }
    }
    // reduce-scatter over t: lane (g, t) keeps rp index 2 t + u, row
    // wm * 64 + 16 t + g + 8 u, summed over the four lanes
    double ry[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
        const double send = t1 ? rp[p] : rp[p + 4];
        const double keep = t1 ? rp[p + 4] : rp[p];
        ry[p] = keep + __shfl_xor_sync(0xffffffffu, send, 2);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
        const double send = t0 ? ry[u] : ry[u + 2];
        const double keep = t0 ? ry[u + 2] : ry[u];
        part[wm * 64 + 16 * t + g + 8 * u] =
            keep + __shfl_xor_sync(0xffffffffu, send, 1);
    }
}

// One class's column partials: sum over this warp's 64 rows of k(row, col)
// w[row], w the class's weights of the row tile; reduced over the eight
// row groups of the warp (a reduce-scatter butterfly over lane bits 4, 3,
// 2, 7 shuffles) into part[col], the warp-down row wm's partials.
__device__ __forceinline__ void dmma_col_partials(const double (&acc)[4][4][4],
                                                  const double* w, int wm,
                                                  int wn, int g, int t,
                                                  double* part) {
    const bool g2 = g & 4, g1 = g & 2, g0 = g & 1;
    // cx[2 n + e] is column wn * 32 + 8 n + 2 t + e over this thread's
    // eight rows
    double cx[8];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            double sum = 0.0;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    sum += acc[i][n][2 * h + e] * w[wm * 64 + 16 * i + g + 8 * h];
                }
            }
            cx[2 * n + e] = sum;
        }
    }
    // lane (g, t) keeps cx index g, column wn * 32 + 8 (g / 2) + 2 t + g % 2
    double cy[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
        const double send = g2 ? cx[p] : cx[p + 4];
        const double keep = g2 ? cx[p + 4] : cx[p];
        cy[p] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
    }
    double cz[2];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
        const double send = g1 ? cy[p] : cy[p + 2];
        const double keep = g1 ? cy[p + 2] : cy[p];
        cz[p] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
    }
    const double send = g0 ? cz[0] : cz[1];
    const double keep = g0 ? cz[1] : cz[0];
    part[wn * 32 + 8 * (g / 2) + 2 * t + g % 2] =
        keep + __shfl_xor_sync(0xffffffffu, send, 4);
}

// Box k of the block's stream of ``total`` boxes: wait for its stage, add
// warp (wm, wn)'s products on it to acc, and release the stage; thread 0
// then refills the stage of box k - 1, which every thread released one box
// ago, with box k - 1 + kDmStages, when the stream has one (load(box,
// stage)).
template <typename Load>
__device__ __forceinline__ void dmma_consume(double (&acc)[4][4][4],
                                             const uint8_t* ring_ptr,
                                             uint64_t* full, uint64_t* empty,
                                             int k, int total, int tid, int wm,
                                             int wn, int g, int t,
                                             const Load& load) {
    const int s = k % kDmStages;
    mbar_wait(smem_address(&full[s]), (k / kDmStages) & 1);
    const uint8_t* xr = ring_ptr + s * kDmStageBytes;
    dmma_box(acc, xr, xr + kDmOperandBytes, wm, wn, g, t);
    mbar_arrive(smem_address(&empty[s]));
    if (k > 0) {
        const int ps = (k - 1) % kDmStages;
        if (tid == 0 && k - 1 + kDmStages < total) {
            mbar_wait(smem_address(&empty[ps]), ((k - 1) / kDmStages) & 1);
            load(k - 1 + kDmStages, ps);
        }
        __syncwarp();
    }
}

// One tile's product: thread 0 fills the ring (stage s <- feature box s
// of the row tile, rows row0.. of rmap, and of the column tile, rows
// col0.. of cmap) and refills a stage once every thread has released it,
// kDmStages - 1 boxes ahead of the product; warp (wm, wn) sets acc to its
// 64 x 32 fragment of the tile's Gram block.  The barriers are initialised
// and visible to every thread before the call.
__device__ __forceinline__ void dmma_tile_product(
    double (&acc)[4][4][4], const CUtensorMap* rmap, const CUtensorMap* cmap,
    int64_t row0, int64_t col0, int nk, uint32_t ring, const uint8_t* ring_ptr,
    uint64_t* full, uint64_t* empty, int tid, int wm, int wn, int g, int t) {
    auto load = [&](int k, int s) {
        const uint32_t bar = smem_address(&full[s]);
        const uint32_t dst = ring + s * kDmStageBytes;
        mbar_expect_tx(bar, kDmStageBytes);
        tma_load(dst, rmap, bar, k * kDmFeatures, static_cast<int>(row0));
        tma_load(dst + kDmOperandBytes, cmap, bar, k * kDmFeatures,
                 static_cast<int>(col0));
    };
    if (tid == 0) {
        for (int s = 0; s < kDmStages && s < nk; ++s) {
            load(s, s);
        }
    }
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
    for (int k = 0; k < nk; ++k) {
        dmma_consume(acc, ring_ptr, full, empty, k, nk, tid, wm, wn, g, t, load);
    }
}

// The entry points' dispatch on the kernel function.
template <typename Launch>
int dmma_dispatch(int kind, const Launch& launch) {
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

}  // namespace
