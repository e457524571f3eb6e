// The tensor-core Gram tile of kernels A and C in the tiers "f32" (TF32
// operands) and "bf16" (bfloat16 operands), f32 accumulation in both: the
// symmetric K(X, X) @ V for V (m, C), C >= 1 (kernel A is C = 1).
//
// Replaces, for those tiers, the Pallas kernels
// plssvm_tpu/ops/pallas_matvec.py kernel_matvec_pallas_dual (K1) and
// kernel_matmat_pallas_dual (K4) with symmetric=True, whose Gram products
// run on the MXU in one pass (the "f32" tier rounds each operand to bf16
// inside the MXU, the "bf16" tier also stores X as bf16; _dot_prec).  The
// "highest" tier and float64 keep the FFMA register tile of gram_tile.cuh.
//
// What bounds it on an H100: the pair work, 2 * pairs * d flops, at the
// tensor cores' 495 TFLOP/s (TF32) or 989 TFLOP/s (bf16), is only reached
// through wgmma; the FFMA tile stops at the 67 TFLOP/s FP32 rate.  A 128 x
// 128 tile does 32 flops per operand byte it stages (TF32), so at those
// rates the operand feed (L2 and HBM), not the tensor cores, is the first
// limit; the epilogue (the kernel function, then a row and a column
// contraction per class with an atomic per row, column and class) comes
// second.  What the design does about it:
//
// - The walk: the upper triangle of 128 x 128 tiles (jt >= it), in groups
//   of kTcGroup column tiles; inside a group the row tiles are the outer
//   index, so the blocks in flight share about 16 row and 16 column panels
//   (a few MB, in the 50 MB L2) and each row panel comes from HBM once per
//   group, not once per column tile.  The diagonal tile contributes rows
//   only, as kernels A and C do.
// - The operand feed: X is K-major for both operands of the Gram product
//   (X_i X_j^T), which wgmma takes from shared memory with the 128-byte
//   swizzle.  The Tensor Memory Accelerator copies 128-row x 128-byte boxes
//   (32 TF32 or 64 bf16 features) into a ring of kTcStages stages, each
//   stage's arrival counted by an mbarrier; it zero-fills rows past m and
//   features past d, so the tile needs no masks in its main loop.  Thread 0
//   refills a stage once both warpgroups have released it (a second
//   mbarrier), kTcStages - 1 stages ahead of the product.
// - The product: two warpgroups of 128 threads, each wgmma m64n128 over its
//   64 rows, 64 f32 accumulators a thread; two blocks fit an SM (96 KB of
//   ring each, at most 128 registers a thread), so one block's epilogue
//   overlaps the other's main loop.
// - The epilogue: the kernel function on the accumulator fragment (sq and
//   gamma as gram_tile.cuh apply_kernel); then per class, in exact f32
//   FFMA as the TPU kernel's row and column contractions, row partials
//   reduced over the 4 lanes of a quad, column partials over the 8 quads of
//   a warp by a reduce-scatter butterfly (28 shuffles for 32 columns) and
//   over the 8 warps through shared memory; one atomicAdd per row and
//   class, and off the diagonal one per column and class.
//
// Numerics: the wrapper hands the kernel a TF32-rounded copy of X
// (round-to-nearest, ties away, as cvt.rna.tf32.f32; wgmma itself would
// drop the low 13 bits and bias every Gram entry toward zero) or a bf16
// copy; the squared norms stay those of the float32 X, as the TPU kernel's.
// The operand copy's row stride must be a multiple of 16 bytes (TMA), so
// its feature axis is padded with zeros to d % 4 (TF32) or d % 8 (bf16).

#pragma once

#include <cuda.h>  // CUtensorMap and its encoder's types; nothing links -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "gram_tile.cuh"

namespace {

constexpr int kTcEdge = 128;       // tile rows = tile columns
constexpr int kTcThreads = 256;    // two warpgroups of 64 rows each
constexpr int kTcWarps = kTcThreads / 32;
constexpr int kTcStages = 3;       // ring depth
constexpr int kTcRowBytes = 128;   // one swizzle row of a box
constexpr int kTcOperandBytes = kTcEdge * kTcRowBytes;  // one box, 16 KB
constexpr int kTcStageBytes = 2 * kTcOperandBytes;      // row and column box
constexpr int kTcSmemBytes = kTcStages * kTcStageBytes + 1024;  // + alignment
constexpr int kTcGroup = 16;       // column tiles per raster group

// the 64 accumulators of one m64n128 wgmma, as asm operands
#define PLSSVM_TC_REGS                                                  \
    "{%0, %1, %2, %3, %4, %5, %6, %7,"                                  \
    " %8, %9, %10, %11, %12, %13, %14, %15,"                            \
    " %16, %17, %18, %19, %20, %21, %22, %23,"                          \
    " %24, %25, %26, %27, %28, %29, %30, %31,"                          \
    " %32, %33, %34, %35, %36, %37, %38, %39,"                          \
    " %40, %41, %42, %43, %44, %45, %46, %47,"                          \
    " %48, %49, %50, %51, %52, %53, %54, %55,"                          \
    " %56, %57, %58, %59, %60, %61, %62, %63}"
#define PLSSVM_TC_OUTS                                                  \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
    "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
    "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
    "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
    "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
    "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
    "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),    \
    "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),    \
    "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),    \
    "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),    \
    "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),    \
    "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),    \
    "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// A tier: the operand's element type for TMA, its size, the features one
// 128-byte swizzle row holds, and d += A B^T over 32 bytes of features
// (one wgmma k-step) with both operands K-major in shared memory.
struct Tf32Tier {
    static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    static constexpr int kItemSize = 4;
    static constexpr int kFeatures = kTcRowBytes / kItemSize;  // 32
    __device__ __forceinline__ static void mma(float (&d)[64], uint64_t a,
                                               uint64_t b) {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "setp.ne.b32 p, %66, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
            PLSSVM_TC_REGS ", %64, %65, p, 1, 1;\n"
            "}\n"
            : PLSSVM_TC_OUTS
            : "l"(a), "l"(b), "r"(1));
    }
};
struct Bf16Tier {
    static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    static constexpr int kItemSize = 2;
    static constexpr int kFeatures = kTcRowBytes / kItemSize;  // 64
    __device__ __forceinline__ static void mma(float (&d)[64], uint64_t a,
                                               uint64_t b) {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "setp.ne.b32 p, %66, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
            PLSSVM_TC_REGS ", %64, %65, p, 1, 1, 0, 0;\n"
            "}\n"
            : PLSSVM_TC_OUTS
            : "l"(a), "l"(b), "r"(1));
    }
};

#undef PLSSVM_TC_REGS
#undef PLSSVM_TC_OUTS

__device__ __forceinline__ uint32_t smem_address(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
                 "r"(count)
                 : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
        "r"(bytes)
        : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
                 : "memory");
}

// until the phase of parity ``parity`` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done = 0;
    do {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
    } while (done == 0);
}

// one box of the tensor map at (feature, row) into shared memory, counted
// on the mbarrier
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int feature, int row) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(feature),
        "r"(row)
        : "memory");
}

// wgmma shared-memory descriptor of a K-major operand in the 128-byte
// swizzle: start address >> 4, leading offset 1 (unused when swizzled),
// 1024 bytes between 8-row groups, layout 1 = 128-byte swizzle.  The
// operand's boxes sit on 1024-byte boundaries; a k-step 32 bytes further
// along the row adds 2 to the start address.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
    return (uint64_t(1) << 62) | (uint64_t(1024 >> 4) << 32) |
           (uint64_t(1) << 16) | uint64_t((addr >> 4) & 0x3FFF);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or copies across the
// asynchronous products
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
        asm volatile("" : "+f"(d[i])::"memory");
    }
}

// Linear block index p -> upper-triangle tile (it, jt), it <= jt, of nt x
// nt tiles, in groups of kTcGroup column tiles [j0, j0 + w): the group's
// rows it < j0 first, w tiles each, then its own triangle, row by row.
__device__ __forceinline__ void grouped_upper_tile(int64_t p, int64_t nt,
                                                   int64_t& it, int64_t& jt) {
    constexpr int64_t G = kTcGroup;
    // tiles before group g (all groups before g are full)
    auto before = [](int64_t g) {
        return G * G * g * (g - 1) / 2 + g * G * (G + 1) / 2;
    };
    int64_t g = 0;
    while (before(g + 1) <= p) {
        ++g;
    }
    const int64_t j0 = g * G;
    const int64_t w = nt - j0 < G ? nt - j0 : G;
    int64_t q = p - before(g);
    if (q < j0 * w) {
        it = q / w;
        jt = j0 + q % w;
        return;
    }
    q -= j0 * w;
    int64_t r = 0;
    while (q >= w - r) {
        q -= w - r;
        ++r;
    }
    it = j0 + r;
    jt = it + q;
}

// out[r, c] += sum_j k(x_r, x_j) V[j, c] over the upper triangle of tiles,
// columns mirrored off the diagonal; X arrives through xmap as the tier's
// operand copy (m rows, its feature axis padded), nk boxes of features.
template <typename Tier, int KIND>
__global__ void __launch_bounds__(kTcThreads, 2)
    gram_tc_sym_kernel(const __grid_constant__ CUtensorMap xmap,
                       const float* __restrict__ sq,
                       const float* __restrict__ V, float* __restrict__ out,
                       int64_t m, int64_t C, int nk, int64_t nt, int degree,
                       float gamma, float coef0) {
    extern __shared__ uint8_t tc_ring[];
    __shared__ __align__(8) uint64_t full[kTcStages];
    __shared__ __align__(8) uint64_t empty[kTcStages];
    __shared__ float sq_r[kTcEdge];
    __shared__ float sq_c[kTcEdge];
    __shared__ float v_rows[kClassChunk][kTcEdge];  // V rows of the row tile
    __shared__ float v_cols[kClassChunk][kTcEdge];  // of the column tile
    __shared__ float col_part[kTcWarps][kTcEdge];

    const int tid = threadIdx.x;
    int64_t it, jt;
    grouped_upper_tile(blockIdx.x, nt, it, jt);
    const int64_t row0 = it * kTcEdge;
    const int64_t col0 = jt * kTcEdge;
    const bool off_diagonal = jt > it;  // uniform per block
    const uint32_t ring = (smem_address(tc_ring) + 1023u) & ~1023u;

    if (tid == 0) {
        for (int s = 0; s < kTcStages; ++s) {
            mbar_init(smem_address(&full[s]), 1);
            mbar_init(smem_address(&empty[s]), kTcThreads);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    if (tid < kTcEdge) {
        const int64_t r = row0 + tid;
        sq_r[tid] = r < m ? sq[r] : 0.0f;
    } else {
        const int64_t c = col0 + tid - kTcEdge;
        sq_c[tid - kTcEdge] = c < m ? sq[c] : 0.0f;
    }
    __syncthreads();

    // stage s <- feature box k of the row and the column tile
    auto load = [&](int k, int s) {
        const uint32_t bar = smem_address(&full[s]);
        const uint32_t dst = ring + s * kTcStageBytes;
        mbar_expect_tx(bar, kTcStageBytes);
        tma_load(dst, &xmap, bar, k * Tier::kFeatures, static_cast<int>(row0));
        tma_load(dst + kTcOperandBytes, &xmap, bar, k * Tier::kFeatures,
                 static_cast<int>(col0));
    };
    if (tid == 0) {
        for (int s = 0; s < kTcStages && s < nk; ++s) {
            load(s, s);
        }
    }

    const int wg = tid / 128;
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) {
        acc[i] = 0.0f;
    }
    for (int k = 0; k < nk; ++k) {
        const int s = k % kTcStages;
        mbar_wait(smem_address(&full[s]), (k / kTcStages) & 1);
        const uint32_t a = ring + s * kTcStageBytes + wg * 64 * kTcRowBytes;
        const uint32_t b = ring + s * kTcStageBytes + kTcOperandBytes;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTcRowBytes / 32; ++kk) {
            Tier::mma(acc, sw128_desc(a + 32 * kk), sw128_desc(b + 32 * kk));
        }
        wgmma_commit();
        fence_acc(acc);
        wgmma_wait<1>();  // this warpgroup's products of box k - 1 are done
        if (k > 0) {
            const int ps = (k - 1) % kTcStages;
            mbar_arrive(smem_address(&empty[ps]));
            if (tid == 0 && k - 1 + kTcStages < nk) {
                mbar_wait(smem_address(&empty[ps]), ((k - 1) / kTcStages) & 1);
                load(k - 1 + kTcStages, ps);
            }
            __syncwarp();
        }
    }
    wgmma_wait<0>();
    fence_acc(acc);

    // the accumulator fragment: acc[4 j + 2 h + e] is row rl[h], column
    // 8 j + 2 q + e of the tile (j < 16, h, e in {0, 1})
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int q = lane % 4;
    const int rl[2] = {wg * 64 + (warp % 4) * 16 + lane / 4,
                       wg * 64 + (warp % 4) * 16 + lane / 4 + 8};
    const bool row_ok[2] = {row0 + rl[0] < m, row0 + rl[1] < m};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int cl = 8 * j + 2 * q + e;
            const bool col_ok = col0 + cl < m;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                float& kv = acc[4 * j + 2 * h + e];
                kv = (row_ok[h] && col_ok)
                    ? apply_kernel<float, KIND>(kv, sq_r[rl[h]], sq_c[cl],
                                                gamma, coef0, degree)
                    : 0.0f;
            }
        }
    }

    const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
    for (int64_t c0 = 0; c0 < C; c0 += kClassChunk) {
        const int cn = static_cast<int>(
            C - c0 < kClassChunk ? C - c0 : kClassChunk);
        __syncthreads();  // the previous chunk's readers are done
        for (int e = tid; e < kTcEdge * cn; e += kTcThreads) {
            const int r = e / cn;
            const int cc = e % cn;
            const int64_t gr = row0 + r;
            const int64_t gc = col0 + r;
            v_rows[cc][r] = gr < m ? V[gr * C + c0 + cc] : 0.0f;
            v_cols[cc][r] = gc < m ? V[gc * C + c0 + cc] : 0.0f;
        }
        __syncthreads();
        for (int cc = 0; cc < cn; ++cc) {
            const int64_t c = c0 + cc;
            // rows: sum over the tile's columns against V of the column tile
            float rs[2] = {0.0f, 0.0f};
#pragma unroll
            for (int j = 0; j < 16; ++j) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const float vc = v_cols[cc][8 * j + 2 * q + e];
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        rs[h] += acc[4 * j + 2 * h + e] * vc;
                    }
                }
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
                rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
                if (q == 0 && row_ok[h]) {
                    atomicAdd(&out[(row0 + rl[h]) * C + c], rs[h]);
                }
            }
            if (!off_diagonal) {
                continue;
            }
            // columns: x[2 j + e] is this thread's share of column
            // 8 j + 2 q + e; the butterfly over lane bits 4, 3, 2 leaves
            // lane with the warp's sums of x index 4 (lane / 4) + p
            const float vr0 = v_rows[cc][rl[0]];
            const float vr1 = v_rows[cc][rl[1]];
            float x[32];
#pragma unroll
            for (int j = 0; j < 16; ++j) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    x[2 * j + e] = acc[4 * j + e] * vr0 + acc[4 * j + 2 + e] * vr1;
                }
            }
            float y[16];
#pragma unroll
            for (int p = 0; p < 16; ++p) {
                const float send = b4 ? x[p] : x[p + 16];
                const float keep = b4 ? x[p + 16] : x[p];
                y[p] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
            }
            float z[8];
#pragma unroll
            for (int p = 0; p < 8; ++p) {
                const float send = b3 ? y[p] : y[p + 8];
                const float keep = b3 ? y[p + 8] : y[p];
                z[p] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
            }
#pragma unroll
            for (int p = 0; p < 4; ++p) {
                const float send = b2 ? z[p] : z[p + 4];
                const float keep = b2 ? z[p + 4] : z[p];
                const float w = keep + __shfl_xor_sync(0xffffffffu, send, 4);
                const int i = 4 * (lane / 4) + p;
                col_part[warp][8 * (i / 2) + 2 * q + i % 2] = w;
            }
            __syncthreads();
            if (tid < kTcEdge && col0 + tid < m) {
                float total = 0.0f;
#pragma unroll
                for (int w = 0; w < kTcWarps; ++w) {
                    total += col_part[w][tid];
                }
                atomicAdd(&out[(col0 + tid) * C + c], total);
            }
            __syncthreads();  // col_part is written again next class
        }
    }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The TMA descriptor of the operand copy X (m, d_pad), boxes of 128 rows x
// 128 bytes in the 128-byte swizzle, zero fill past the edges.
// cuTensorMapEncodeTiled comes through the runtime's entry-point query, so
// the library links the CUDA runtime alone (no -lcuda).
template <typename Tier>
cudaError_t encode_operand(CUtensorMap* map, const void* X, int64_t m,
                           int64_t d_pad) {
    static EncodeTiled encode = nullptr;
    if (encode == nullptr) {
        void* fn = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t err = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
        if (err != cudaSuccess) {
            return err;
        }
        if (found != cudaDriverEntryPointSuccess || fn == nullptr) {
            return cudaErrorSymbolNotFound;
        }
        encode = reinterpret_cast<EncodeTiled>(fn);
    }
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d_pad),
                                static_cast<cuuint64_t>(m)};
    const cuuint64_t strides[1] = {
        static_cast<cuuint64_t>(d_pad) * Tier::kItemSize};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(Tier::kFeatures),
                               static_cast<cuuint32_t>(kTcEdge)};
    const cuuint32_t steps[2] = {1, 1};
    const CUresult r = encode(
        map, Tier::kType, 2, const_cast<void*>(X), dims, strides, box, steps,
        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename Tier, int KIND>
cudaError_t launch_tc_sym(const void* X, const float* sq, const float* V,
                          float* out, int64_t m, int64_t d_pad, int64_t C,
                          int degree, float gamma, float coef0,
                          cudaStream_t stream) {
    const int64_t nt = (m + kTcEdge - 1) / kTcEdge;
    const int64_t blocks = nt * (nt + 1) / 2;
    const int64_t nk = (d_pad + Tier::kFeatures - 1) / Tier::kFeatures;
    if (blocks <= 0 || blocks > INT32_MAX || C <= 0 || nk <= 0 ||
        m > INT32_MAX || d_pad % (16 / Tier::kItemSize) != 0 ||
        reinterpret_cast<uintptr_t>(X) % 16 != 0) {
        return cudaErrorInvalidValue;
    }
    CUtensorMap map;
    cudaError_t err = encode_operand<Tier>(&map, X, m, d_pad);
    if (err != cudaSuccess) {
        return err;
    }
    auto kernel = gram_tc_sym_kernel<Tier, KIND>;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kTcSmemBytes);
    if (err != cudaSuccess) {
        return err;
    }
    kernel<<<static_cast<unsigned int>(blocks), kTcThreads, kTcSmemBytes,
             stream>>>(map, sq, V, out, m, C, static_cast<int>(nk), nt,
                       degree, gamma, coef0);
    return cudaGetLastError();
}

// The entry points' dispatch over the tier and the kernel function.
inline int tc_sym(bool bf16, const void* X, const float* sq, const float* V,
                  float* out, int64_t m, int64_t d_pad, int64_t C, int kind,
                  int degree, float gamma, float coef0, void* stream) {
    const auto s = static_cast<cudaStream_t>(stream);
    if (bf16) {
        switch (kind) {
            case kPolynomial:
                return launch_tc_sym<Bf16Tier, kPolynomial>(
                    X, sq, V, out, m, d_pad, C, degree, gamma, coef0, s);
            case kRbf:
                return launch_tc_sym<Bf16Tier, kRbf>(
                    X, sq, V, out, m, d_pad, C, degree, gamma, coef0, s);
            case kSigmoid:
                return launch_tc_sym<Bf16Tier, kSigmoid>(
                    X, sq, V, out, m, d_pad, C, degree, gamma, coef0, s);
            default:
                return cudaErrorInvalidValue;
        }
    }
    switch (kind) {
        case kPolynomial:
            return launch_tc_sym<Tf32Tier, kPolynomial>(
                X, sq, V, out, m, d_pad, C, degree, gamma, coef0, s);
        case kRbf:
            return launch_tc_sym<Tf32Tier, kRbf>(
                X, sq, V, out, m, d_pad, C, degree, gamma, coef0, s);
        case kSigmoid:
            return launch_tc_sym<Tf32Tier, kSigmoid>(
                X, sq, V, out, m, d_pad, C, degree, gamma, coef0, s);
        default:
            return cudaErrorInvalidValue;
    }
}

}  // namespace
