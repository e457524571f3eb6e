// The tensor-core Gram tiles of kernels A-D, J and K in the tiers "f32"
// (TF32 operands) and "bf16" (bfloat16 operands), and of A-D and K in
// "highest" (three TF32 passes over the split operand), f32 accumulation in
// all:
// the symmetric K(X, X) @ V for V (m, C) (kernels A and C, C = 1 for A), the
// rectangular K(P, S) @ A for points P, support vectors S and A (n_s, C)
// (kernels B and D, C = 1 for B), and the dual (K @ V_c, K^T @ V_r) of one
// off-diagonal block K = K(Xr, Xc) of the row-sharded ring (kernels J and
// K, C = 1 for J).
//
// Replaces, for those tiers, the Pallas kernels of
// plssvm_tpu/ops/pallas_matvec.py whose Gram products run on the MXU in one
// pass (the "f32" tier rounds each operand to bf16 inside the MXU, the
// "bf16" tier also stores the operands as bf16; _dot_prec):
// kernel_matvec_pallas_dual (K1) and kernel_matmat_pallas_dual (K4) with
// symmetric=True on the symmetric tile; kernel_matvec_pallas_rect (K3, its
// fulld and blocked bodies alike) and K4 with symmetric=False (predict) on
// the rectangular tile; K1 and K4 with symmetric=False and both outputs
// (bodies _matvec_kernel_dual and _matmat_kernel_dual, the reference ring's
// cross_dual in plssvm_tpu/parallel/sharded.py) on the dual tile.  At
// "highest" the reference's dots are multi-pass f32 on the MXU
// (lax.Precision.HIGHEST, "roughly 1/3 the MXU rate", pallas_matvec.py:40
// and _dot_prec); here A-D and K take the same symmetric, rectangular and
// dual tiles with three TF32 passes (Tf32x3Tier, below), where the FFMA
// register tiles of gram_tile.cuh and K's FFMA walk of dual.cu stopped at
// the 67 TFLOP/s FP32 rate; J at "highest" keeps the matvec walk of
// dual.cu.  In float64 A-D, J and K run
// on the FP64 tensor cores (the DMMA tiles of gram_dmma.cu, which share
// this file's TMA and mbarrier helpers and the grouped raster).
//
// What bounds them on an H100: the pair work, 2 * pairs * d flops, at the
// tensor cores' 495 TFLOP/s (TF32) or 989 TFLOP/s (bf16), is only reached
// through wgmma; the FFMA tile stops at the 67 TFLOP/s FP32 rate.  A 128 x
// 128 tile does 32 flops per operand byte it stages (TF32), so at those
// rates the operand feed (L2 and HBM), not the tensor cores, is the first
// limit; the epilogue (the kernel function, then the contraction per class
// with its partials' slots, fixed_sum.cuh) comes second.  What the design does about it:
//
// - The operand feed: the Gram product X_i X_j^T (or P_i S_j^T) takes both
//   operands K-major, which wgmma reads from shared memory with the
//   128-byte swizzle.  The Tensor Memory Accelerator copies 128-row x
//   128-byte boxes (32 TF32 or 64 bf16 features) into a ring of kTcStages
//   stages, each stage's arrival counted by an mbarrier; it zero-fills rows
//   past the operand's end and features past d, so the tiles need no masks
//   in their main loops.  Thread 0 refills a stage once both warpgroups
//   have released it (a second mbarrier), kTcStages - 1 stages ahead of the
//   product.
// - The product: two warpgroups of 128 threads, each wgmma m64n128 over its
//   64 rows, 64 f32 accumulators a thread; two blocks fit an SM (96 KB of
//   ring each, at most 128 registers a thread), so one block's epilogue
//   overlaps the other's main loop.
// - The symmetric walk: the upper triangle of 128 x 128 tiles (jt >= it), in
//   groups of kTcGroup column tiles; inside a group the row tiles are the
//   outer index, so the blocks in flight share about 16 row and 16 column
//   panels (a few MB, in the 50 MB L2) and each row panel comes from HBM
//   once per group, not once per column tile.  The diagonal tile
//   contributes rows only, as kernels A and C do.  Its epilogue: per class,
//   in exact f32 FFMA as the TPU kernel's row and column contractions, row
//   partials reduced over the 4 lanes of a quad, column partials over the 8
//   quads of a warp by a reduce-scatter butterfly (28 shuffles for 32
//   columns) and over the 8 warps through shared memory; one slot store
//   per row and class, and off the diagonal one per column and class.
// - The rectangular walk: every (row tile, column tile) of the n_p x n_s
//   rectangle.  A block takes one row tile and a run of up to kTcMaxRun
//   consecutive column tiles, streamed through the ring as one sequence of
//   boxes, so the next tile's first boxes load during this tile's
//   epilogue.  It keeps its rows' sums of the run in shared memory (the
//   first kTcRunClasses classes; each row of the tile belongs to one quad,
//   so no two threads add to one entry) and stores them in the run's slot
//   once, one store per row, class and run instead of per tile (at MNIST's
//   width, 10000 points against 60000 SVs, a row would otherwise take 469
//   column tiles x 10 classes of slots).  The run is as long as
//   the grid still gives kTcRunWaves waves of blocks (tc_run_length), so
//   config 2's 2000 points (16 row tiles x 79 column tiles) take runs of 1
//   and fill the card.  Timed in interleaved pairs on an H100, these runs
//   beat runs of one tile in every pair, and a tile per block with its
//   epilogue after the box loop was slower than both (PERF.md).  The
//   groups hold the points: kTcGroup row tiles, the runs the outer index
//   inside a group and the row tiles the inner one, so
//   the blocks in flight read the same S panels at about the same time and
//   the group's P panels (at MNIST's width P is 31 MB, S 188 MB as TF32)
//   stay in L2 across the whole pass over S; S comes from HBM once per
//   group, P once.  Its epilogue is the row contraction alone: A's rows of
//   the column tile staged kClassChunk classes at a time, row partials
//   reduced over the quad.  The epilogue sits inside the box loop, so its
//   registers add to the loop's: a tile's first product overwrites the
//   accumulators (wgmma's scale-d 0) instead of 64 moves zeroing them, and
//   rows, columns and classes are 32-bit (TMA's coordinates are 32-bit
//   anyway).  With 64-bit indices and the zeroing the tile spilled some 300
//   bytes at its 128-register cap and ran slower on an H100 (PERF.md).
// - The dual walk: the rectangular walk over every tile of the mr x mc
//   block (two tensor maps, runs, the run's row sums in shared memory), with
//   the symmetric tile's off-diagonal epilogue on every tile.  Its bounds:
//   2 mr mc d flops at the tier's peak, then the operand feed as above, then
//   the two-way epilogue: per tile and class 64 FFMAs for the rows and 32
//   plus the butterfly for the columns a thread, and 128 column slot
//   stores that no run can merge (the columns change from tile to tile;
//   the rows take one slot per run).  What the design does about them: the same
//   wgmma product and TMA ring as the other tiles, two blocks an SM at the
//   one-pass tiers so one block's epilogue overlaps the other's products,
//   and the class sums in exact f32 FFMA as the TPU kernel's contractions
//   (a second MMA for the class contraction is untried).  At the split tier
//   the dual tile takes the split stage of the sym and rect tiles (both
//   parts of both boxes, three products a stage, one block an SM), which
//   on an H100 beat 3 nk one-part boxes at two blocks an SM at the ring's
//   15000^2 x 784 block with 10 classes (PERF.md).  The sym and rect tiles'
//   own code stays as it was: the dual kernel is built from the rect tile's
//   pieces and a copy of the sym tile's butterfly (tc_col_sums).
//
// Numerics: the wrapper hands the kernels a TF32-rounded copy of each
// operand (round-to-nearest, ties away, as cvt.rna.tf32.f32; wgmma itself
// would drop the low 13 bits and bias every Gram entry toward zero), a
// bf16 copy, or at "highest" the split stack [hi; lo] (hi the TF32 copy,
// lo = tf32(x - hi), both exact TF32, so wgmma reads them whole); the
// squared norms stay those of the float32 operands, as the TPU kernel's.
// The operand copies' row stride must be a multiple of 16 bytes (TMA), so
// their feature axis is padded with zeros to d % 4 (TF32 and the split)
// or d % 8 (bf16); P and S take the same padding.  The split tier walks
// the same nk feature boxes as TF32, each stage holding both parts of the
// row and of the column box (a 3-D tensor map over the stack, one part a
// box) for three products: each operand box is staged once for its two
// products, where a walk of 3 nk one-part boxes (tried first) stages it
// three times and read 7-11 % slower on an H100 at two blocks an SM
// (PERF.md).  Its 64 KB stages leave one block an SM; the one-pass tiers'
// code is the same as before (one part, two blocks an SM).

#pragma once

#include <cuda.h>  // CUtensorMap and its encoder's types; nothing links -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

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
constexpr int kTcGroup = 16;       // column (sym) / row (rect) tiles per group
constexpr int kTcMaxRun = 8;       // column tiles a rect block walks at most
constexpr int kTcRunWaves = 4;     // waves of rect blocks the run must leave
constexpr int kTcRunClasses = 16;  // classes whose row sums a run keeps

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
// 128-byte swizzle row holds, and d = scale_d * d + A B^T over 32 bytes of
// features (one wgmma k-step) with both operands K-major in shared memory.
struct Tf32Tier {
    static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    static constexpr int kItemSize = 4;
    static constexpr int kFeatures = kTcRowBytes / kItemSize;  // 32
    static constexpr int kPasses = 1;       // products a stage adds
    static constexpr int kParts = 1;        // operand parts a stage holds
    static constexpr int kBlocksPerSm = 2;  // the tiles' __launch_bounds__
    __device__ __forceinline__ static void mma(float (&d)[64], uint64_t a,
                                               uint64_t b,
                                               uint32_t scale_d = 1) {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "setp.ne.b32 p, %66, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
            PLSSVM_TC_REGS ", %64, %65, p, 1, 1;\n"
            "}\n"
            : PLSSVM_TC_OUTS
            : "l"(a), "l"(b), "r"(scale_d));
    }
};
struct Bf16Tier {
    static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    static constexpr int kItemSize = 2;
    static constexpr int kFeatures = kTcRowBytes / kItemSize;  // 64
    static constexpr int kPasses = 1;
    static constexpr int kParts = 1;
    static constexpr int kBlocksPerSm = 2;
    __device__ __forceinline__ static void mma(float (&d)[64], uint64_t a,
                                               uint64_t b,
                                               uint32_t scale_d = 1) {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "setp.ne.b32 p, %66, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
            PLSSVM_TC_REGS ", %64, %65, p, 1, 1, 0, 0;\n"
            "}\n"
            : PLSSVM_TC_OUTS
            : "l"(a), "l"(b), "r"(scale_d));
    }
};

// The "highest" tier: the TF32 product in three passes over the operand's
// split (2, rows, d_pad) stack [hi; lo], hi = tf32(x), lo = tf32(x - hi).
// A stage holds both parts of the row and of the column box side by side
// (row hi, row lo, column hi, column lo: 64 KB), and pass p multiplies the
// row part row_part(p) by the column part col_part(p), so one accumulator
// walk sums hi hi^T + hi lo^T + lo hi^T, feature box by feature box.  The
// dropped lo lo^T and lo's own rounding leave about 2^-22 relative per
// product, where one float32 product rounds to 2^-24.  Three 64 KB stages
// leave one block an SM.
struct Tf32x3Tier : Tf32Tier {
    static constexpr int kPasses = 3;
    static constexpr int kParts = 2;
    static constexpr int kBlocksPerSm = 1;
    __device__ __forceinline__ static int row_part(int pass) { return pass == 2; }
    __device__ __forceinline__ static int col_part(int pass) { return pass == 1; }
};

// A tier's ring: a stage holds the row and the column box of each part it
// reads; the whole ring is the dynamic shared memory of the sym and rect
// tiles (with 1024 bytes to align it).
template <typename Tier>
__host__ __device__ constexpr int tc_stage_bytes() {
    return 2 * Tier::kParts * kTcOperandBytes;
}
template <typename Tier>
__host__ __device__ constexpr int tc_smem_bytes() {
    return kTcStages * tc_stage_bytes<Tier>() + 1024;
}
static_assert(tc_smem_bytes<Tf32Tier>() == kTcSmemBytes, "the one-pass ring");

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

// one box of a split stack's 3-D tensor map at (feature, row, part)
__device__ __forceinline__ void tma_load_part(uint32_t dst, const CUtensorMap* map,
                                              uint32_t bar, int feature, int row,
                                              int part) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(feature),
        "r"(row), "r"(part)
        : "memory");
}

// Stage feature box k of the row tile at row0 and of the column tile at
// col0 into the stage at dst: the row box then the column box, or for the
// split tier both parts of each (row hi, row lo, column hi, column lo);
// the one-pass tiers read the 2-D maps as they always have.
template <typename Tier>
__device__ __forceinline__ void tc_load_boxes(uint32_t dst, const CUtensorMap* rmap,
                                              const CUtensorMap* cmap, uint32_t bar,
                                              int k, int row0, int col0) {
    const int feature = k * Tier::kFeatures;
    if constexpr (Tier::kParts == 1) {
        tma_load(dst, rmap, bar, feature, row0);
        tma_load(dst + kTcOperandBytes, cmap, bar, feature, col0);
    } else {
        tma_load_part(dst, rmap, bar, feature, row0, 0);
        tma_load_part(dst + kTcOperandBytes, rmap, bar, feature, row0, 1);
        tma_load_part(dst + 2 * kTcOperandBytes, cmap, bar, feature, col0, 0);
        tma_load_part(dst + 3 * kTcOperandBytes, cmap, bar, feature, col0, 1);
    }
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

// The partials of out[r, c] = sum_j k(x_r, x_j) V[j, c] over the tiles of
// one pass of the upper triangle (fixed_sum.cuh SymPass), columns mirrored
// off the diagonal, into their slots of ws; X arrives through xmap as the
// tier's operand copy (m rows, its feature axis padded; the "highest"
// tier's split stack), nk boxes of features.
template <typename Tier, int KIND>
__global__ void __launch_bounds__(kTcThreads, Tier::kBlocksPerSm)
    gram_tc_sym_kernel(const __grid_constant__ CUtensorMap xmap,
                       const float* __restrict__ sq,
                       const float* __restrict__ V, float* __restrict__ ws,
                       const SymPass pass, int64_t m, int64_t C, int nk,
                       int64_t nt, int degree, float gamma, float coef0) {
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
    grouped_upper_tile(pass.first_block() + blockIdx.x, nt, it, jt);
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
    constexpr int kStage = tc_stage_bytes<Tier>();
    auto load = [&](int k, int s) {
        const uint32_t bar = smem_address(&full[s]);
        mbar_expect_tx(bar, kStage);
        tc_load_boxes<Tier>(ring + s * kStage, &xmap, &xmap, bar, k,
                            static_cast<int>(row0), static_cast<int>(col0));
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
        const uint32_t a = ring + s * kStage + wg * 64 * kTcRowBytes;
        const uint32_t b = ring + s * kStage + Tier::kParts * kTcOperandBytes;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTcRowBytes / 32; ++kk) {
            Tier::mma(acc, sw128_desc(a + 32 * kk), sw128_desc(b + 32 * kk));
        }
        if constexpr (Tier::kPasses > 1) {
            // the split tier's other passes on the same stage
#pragma unroll
            for (int p = 1; p < Tier::kPasses; ++p) {
                const uint32_t ap = a + Tier::row_part(p) * kTcOperandBytes;
                const uint32_t bp = b + Tier::col_part(p) * kTcOperandBytes;
#pragma unroll
                for (int kk = 0; kk < kTcRowBytes / 32; ++kk) {
                    Tier::mma(acc, sw128_desc(ap + 32 * kk), sw128_desc(bp + 32 * kk));
                }
            }
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
                    ws[pass.slot(row0 + rl[h], jt) + c] = rs[h];
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
                ws[pass.slot(col0 + tid, it) + c] = total;
            }
            __syncthreads();  // col_part is written again next class
        }
    }
}

// The rectangular tile's pieces.  The symmetric kernel above keeps its own
// copy of the main loop and the epilogue: built from these pieces, ptxas
// serialised its wgmma (its warning C7515) and it ran slower on an H100.

// Thread 0: each stage's "full" barrier counts one arrival (the refill's,
// with its bytes), its "empty" barrier one per thread (the release).
__device__ __forceinline__ void tc_init_barriers(uint64_t* full,
                                                 uint64_t* empty) {
    for (int s = 0; s < kTcStages; ++s) {
        mbar_init(smem_address(&full[s]), 1);
        mbar_init(smem_address(&empty[s]), kTcThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Box g of the block's stream of ``total`` boxes: wait for its stage, add
// this warpgroup's products on it to acc, and once the products of box
// g - 1 are done release that box's stage; thread 0 then refills the stage
// with box g - 1 + kTcStages, when the stream has one (load(box, stage)).
// Unless ``accumulate``, the box's first product overwrites acc (wgmma's
// scale-d 0).  On return the products of box g may still run.
template <typename Tier, typename Load>
__device__ __forceinline__ void tc_consume(float (&acc)[64], uint32_t ring,
                                           uint64_t* full, uint64_t* empty,
                                           int g, int total, int tid,
                                           bool accumulate, const Load& load) {
    const int s = g % kTcStages;
    mbar_wait(smem_address(&full[s]), (g / kTcStages) & 1);
    const int wg = tid / 128;
    constexpr int kStage = tc_stage_bytes<Tier>();
    const uint32_t a = ring + s * kStage + wg * 64 * kTcRowBytes;
    const uint32_t b = ring + s * kStage + Tier::kParts * kTcOperandBytes;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcRowBytes / 32; ++kk) {
        Tier::mma(acc, sw128_desc(a + 32 * kk), sw128_desc(b + 32 * kk),
                  (kk > 0 || accumulate) ? 1u : 0u);
    }
    if constexpr (Tier::kPasses > 1) {
        // the split tier's other passes on the same stage
#pragma unroll
        for (int p = 1; p < Tier::kPasses; ++p) {
            const uint32_t ap = a + Tier::row_part(p) * kTcOperandBytes;
            const uint32_t bp = b + Tier::col_part(p) * kTcOperandBytes;
#pragma unroll
            for (int kk = 0; kk < kTcRowBytes / 32; ++kk) {
                Tier::mma(acc, sw128_desc(ap + 32 * kk), sw128_desc(bp + 32 * kk));
            }
        }
    }
    wgmma_commit();
    fence_acc(acc);
    wgmma_wait<1>();  // this warpgroup's products of box g - 1 are done
    if (g > 0) {
        const int ps = (g - 1) % kTcStages;
        mbar_arrive(smem_address(&empty[ps]));
        if (tid == 0 && g - 1 + kTcStages < total) {
            mbar_wait(smem_address(&empty[ps]), ((g - 1) / kTcStages) & 1);
            load(g - 1 + kTcStages, ps);
        }
        __syncwarp();
    }
}

// The accumulator fragment of the m64n128 products: acc[4 j + 2 h + e] is
// row rl[h] = wg * 64 + (warp % 4) * 16 + lane / 4 + 8 h, column 8 j + 2 q + e
// of the tile, q = lane % 4 (j < 16, h, e in {0, 1}).
struct TcFragment {
    int q;
    int rl[2];
    __device__ __forceinline__ explicit TcFragment(int tid) {
        const int lane = tid % 32;
        const int base = (tid / 128) * 64 + ((tid / 32) % 4) * 16 + lane / 4;
        q = lane % 4;
        rl[0] = base;
        rl[1] = base + 8;
    }
};

// In place: the Gram fragment becomes the kernel values k(row, col), 0 for a
// row outside the operand (row_ok) or a column past n_cols; sq_r / sq_c the
// tile's squared norms in shared memory.
template <int KIND>
__device__ __forceinline__ void tc_kernel_fragment(
    float (&acc)[64], const TcFragment& f, const bool (&row_ok)[2],
    const float* sq_r, const float* sq_c, int col0, int n_cols,
    int degree, float gamma, float coef0) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int cl = 8 * j + 2 * f.q + e;
            const bool col_ok = col0 + cl < n_cols;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                float& kv = acc[4 * j + 2 * h + e];
                kv = (row_ok[h] && col_ok)
                    ? apply_kernel<float, KIND>(kv, sq_r[f.rl[h]], sq_c[cl],
                                                gamma, coef0, degree)
                    : 0.0f;
            }
        }
    }
}

// This thread's two rows of sum over the tile's columns of k(row, col)
// w[col], w one class's weights of the column tile in shared memory,
// reduced over the 4 lanes of the quad that holds the rows.
__device__ __forceinline__ void tc_row_sums(const float (&acc)[64],
                                            const float* w, int q,
                                            float (&rs)[2]) {
    rs[0] = 0.0f;
    rs[1] = 0.0f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const float wc = w[8 * j + 2 * q + e];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                rs[h] += acc[4 * j + 2 * h + e] * wc;
            }
        }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
        rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
    }
}

// Linear block index p -> row tile it and the first column tile jt0 of its
// run, for n_pt row tiles and n_runs runs of ``run`` column tiles: groups of
// kTcGroup row tiles [i0, i0 + w), inside a group the run the outer index
// and the row tile the inner one (all groups before the last are full).
__device__ __forceinline__ void grouped_rect_run(int64_t p, int64_t n_pt,
                                                 int64_t n_runs, int64_t run,
                                                 int64_t& it, int64_t& jt0) {
    constexpr int64_t G = kTcGroup;
    const int64_t g = p / (G * n_runs);
    const int64_t i0 = g * G;
    const int64_t w = n_pt - i0 < G ? n_pt - i0 : G;
    const int64_t q = p - g * G * n_runs;
    it = i0 + q % w;
    jt0 = (q / w) * run;
}

// The partial of out[r, c] = sum_j k(p_r, s_j) A[j, c] over row tile it and
// the column tiles [jt0, jt0 + run) of the rectangle into its slot
// ws[(q ws_rows + r) C + c] for run q = jt0 / run (fixed_sum.cuh run_rows);
// P (a band of rows) and S arrive through pmap and smap as the tier's
// operand copies (n_p and n_s rows, the same padded feature axis; the
// "highest" tier's split stacks), nk boxes of features per tile.
template <typename Tier, int KIND>
__global__ void __launch_bounds__(kTcThreads, Tier::kBlocksPerSm)
    gram_tc_rect_kernel(const __grid_constant__ CUtensorMap pmap,
                        const __grid_constant__ CUtensorMap smap,
                        const float* __restrict__ sq_p,
                        const float* __restrict__ sq_s,
                        const float* __restrict__ A, float* __restrict__ ws,
                        int ws_rows, int n_p, int n_s, int C, int nk, int n_pt,
                        int n_st, int run, int degree, float gamma,
                        float coef0) {
    extern __shared__ uint8_t tc_ring[];
    __shared__ __align__(8) uint64_t full[kTcStages];
    __shared__ __align__(8) uint64_t empty[kTcStages];
    __shared__ float sq_r[kTcEdge];
    __shared__ float sq_c[kTcEdge];
    __shared__ float a_cols[kClassChunk][kTcEdge];     // A rows of the column tile
    __shared__ float row_acc[kTcRunClasses][kTcEdge];  // the run's row sums

    const int tid = threadIdx.x;
    int64_t it64, jt64;
    grouped_rect_run(blockIdx.x, n_pt, (n_st + run - 1) / run, run, it64, jt64);
    const int row0 = static_cast<int>(it64) * kTcEdge;
    const int jt0 = static_cast<int>(jt64);
    const int tiles = n_st - jt0 < run ? n_st - jt0 : run;
    const int total = tiles * nk;
    const uint32_t ring = (smem_address(tc_ring) + 1023u) & ~1023u;
    float* const slot = ws + int64_t(jt0 / run) * ws_rows * C;

    if (tid == 0) {
        tc_init_barriers(full, empty);
    }
    if (tid < kTcEdge) {
        const int r = row0 + tid;
        sq_r[tid] = r < n_p ? sq_p[r] : 0.0f;
    }
    for (int e = tid; e < kTcRunClasses * kTcEdge; e += kTcThreads) {
        row_acc[e / kTcEdge][e % kTcEdge] = 0.0f;
    }
    __syncthreads();

    // stage s <- box g of the run: feature box g % nk of the row tile and
    // of column tile jt0 + g / nk
    constexpr int kStage = tc_stage_bytes<Tier>();
    auto load = [&](int g, int s) {
        const uint32_t bar = smem_address(&full[s]);
        mbar_expect_tx(bar, kStage);
        tc_load_boxes<Tier>(ring + s * kStage, &pmap, &smap, bar, g % nk, row0,
                            (jt0 + g / nk) * kTcEdge);
    };
    if (tid == 0) {
        for (int s = 0; s < kTcStages && s < total; ++s) {
            load(s, s);
        }
    }

    const TcFragment f(tid);
    const bool row_ok[2] = {row0 + f.rl[0] < n_p, row0 + f.rl[1] < n_p};
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) {
        acc[i] = 0.0f;
    }
    for (int g = 0; g < total; ++g) {
        // a tile's first box overwrites the accumulators (scale-d 0)
        tc_consume<Tier>(acc, ring, full, empty, g, total, tid, g % nk != 0,
                         load);
        if (g % nk != nk - 1) {
            continue;
        }
        // the tile's last box: its epilogue, while the next tile's first
        // boxes load
        wgmma_wait<0>();
        fence_acc(acc);
        const int col0 = (jt0 + g / nk) * kTcEdge;
        __syncthreads();  // the previous tile's readers of sq_c, a_cols are done
        if (tid < kTcEdge) {
            const int c = col0 + tid;
            sq_c[tid] = c < n_s ? sq_s[c] : 0.0f;
        }
        __syncthreads();
        tc_kernel_fragment<KIND>(acc, f, row_ok, sq_r, sq_c, col0, n_s,
                                 degree, gamma, coef0);
        for (int c0 = 0; c0 < C; c0 += kClassChunk) {
            const int cn = C - c0 < kClassChunk ? C - c0 : kClassChunk;
            if (c0 > 0) {
                __syncthreads();  // the previous chunk's readers are done
            }
            for (int e = tid; e < kTcEdge * cn; e += kTcThreads) {
                const int r = e / cn;
                const int cc = e % cn;
                const int gc = col0 + r;
                a_cols[cc][r] = gc < n_s ? A[int64_t(gc) * C + c0 + cc] : 0.0f;
            }
            __syncthreads();
            for (int cc = 0; cc < cn; ++cc) {
                const int c = c0 + cc;
                float rs[2];
                tc_row_sums(acc, a_cols[cc], f.q, rs);
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    if (f.q == 0 && row_ok[h]) {
                        if (c < kTcRunClasses) {
                            row_acc[c][f.rl[h]] += rs[h];
                        } else {
                            // this thread's own slot entry: the run's first
                            // tile writes it, the others add to it
                            float& dst = slot[int64_t(row0 + f.rl[h]) * C + c];
                            dst = g < nk ? rs[h] : dst + rs[h];
                        }
                    }
                }
            }
        }
    }

    // the run's row sums into the run's slot, one store per row and class
    const int rc = C < kTcRunClasses ? C : kTcRunClasses;
    __syncthreads();
    for (int e = tid; e < kTcEdge * rc; e += kTcThreads) {
        const int r = e / rc;
        const int c = e % rc;
        if (row0 + r < n_p) {
            slot[int64_t(row0 + r) * C + c] = row_acc[c][r];
        }
    }
}

// The dual tile's shared memory beside its ring.  Two blocks an SM leave
// each block 16 KB of it (228 KB an SM, the ring's 97 KB and the 1 KB the
// system keeps per block), where the sym and rect tiles' 13 KB took V rows
// of one tile, or run sums of 16 classes, 8 classes at a time: here the V
// rows of both tiles come kTcDualChunk classes at a time, and the run keeps
// the row sums of the first kTcDualRunClasses classes (MNIST's 10 fit).
constexpr int kTcDualChunk = 4;
constexpr int kTcDualRunClasses = 12;
struct TcDualShared {
    uint64_t full[kTcStages];
    uint64_t empty[kTcStages];
    float sq_r[kTcEdge];
    float sq_c[kTcEdge];
    float v_rows[kTcDualChunk][kTcEdge];  // V_r rows of the row tile
    float v_cols[kTcDualChunk][kTcEdge];  // V_c rows of the column tile
    float col_part[kTcWarps][kTcEdge];    // a class's column sums per warp
    float row_acc[kTcDualRunClasses][kTcEdge];  // the run's row sums
};
static_assert(2 * (kTcSmemBytes + sizeof(TcDualShared) + 1024) <= 228 * 1024,
              "two dual blocks must fit an SM");
static_assert(tc_smem_bytes<Tf32x3Tier>() + sizeof(TcDualShared) <= 227 * 1024,
              "a split dual block must fit the shared memory a block may take");

// One class's column sums of the kernel fragment, weighted by the V_r
// values vr0 / vr1 of this thread's two rows: x[2 j + e] is this thread's
// share of column 8 j + 2 q + e; the butterfly over lane bits 4, 3, 2 (28
// shuffles for 32 columns) leaves each lane the warp's sums of x index
// 4 (lane / 4) + p, stored in the warp's row of col_part.  The sym tile's
// off-diagonal column sums, which keeps its own copy.
__device__ __forceinline__ void tc_col_sums(const float (&acc)[64], float vr0,
                                            float vr1, int lane,
                                            float* col_part) {
    const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
    const int q = lane % 4;
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
        col_part[8 * (i / 2) + 2 * q + i % 2] = w;
    }
}

// The partials of out_r[r, c] = sum_j k(xr_r, xc_j) Vc[j, c] over row tile
// it and the column tiles [jt0, jt0 + run) of the mr x mc block, into
// ws_r[(q ws_rows + r) C + c] for run q = jt0 / run, and of out_c[j, c] =
// sum_r k(xr_r, xc_j) Vr[r, c] over each of those tiles, into ws_c[(it mc +
// j) C + c] (fixed_sum.cuh run_rows): the rect tile's walk with both
// contractions.  Xr (a band of rows) and Xc arrive through rmap and cmap as
// the tier's operand copies (mr and mc rows, the same padded feature axis),
// nk boxes of features per tile.
template <typename Tier, int KIND>
__global__ void __launch_bounds__(kTcThreads, Tier::kBlocksPerSm)
    gram_tc_dual_kernel(const __grid_constant__ CUtensorMap rmap,
                        const __grid_constant__ CUtensorMap cmap,
                        const float* __restrict__ sq_r,
                        const float* __restrict__ sq_c,
                        const float* __restrict__ Vc,
                        const float* __restrict__ Vr,
                        float* __restrict__ ws_r, float* __restrict__ ws_c,
                        int ws_rows, int mr, int mc, int C, int nk, int n_rt,
                        int n_ct, int run, int degree, float gamma,
                        float coef0) {
    extern __shared__ uint8_t tc_ring[];
    __shared__ TcDualShared sh;

    const int tid = threadIdx.x;
    int64_t it64, jt64;
    grouped_rect_run(blockIdx.x, n_rt, (n_ct + run - 1) / run, run, it64, jt64);
    const int row0 = static_cast<int>(it64) * kTcEdge;
    const int jt0 = static_cast<int>(jt64);
    const int tiles = n_ct - jt0 < run ? n_ct - jt0 : run;
    const int total = tiles * nk;
    const uint32_t ring = (smem_address(tc_ring) + 1023u) & ~1023u;
    float* const slot_r = ws_r + int64_t(jt0 / run) * ws_rows * C;
    float* const slot_c = ws_c + it64 * mc * C;

    if (tid == 0) {
        tc_init_barriers(sh.full, sh.empty);
    }
    if (tid < kTcEdge) {
        const int r = row0 + tid;
        sh.sq_r[tid] = r < mr ? sq_r[r] : 0.0f;
    }
    for (int e = tid; e < kTcDualRunClasses * kTcEdge; e += kTcThreads) {
        sh.row_acc[e / kTcEdge][e % kTcEdge] = 0.0f;
    }
    __syncthreads();

    // stage s <- box g of the run: feature box g % nk of the row tile and
    // of column tile jt0 + g / nk (at the split tier both parts of each)
    constexpr int kStage = tc_stage_bytes<Tier>();
    auto load = [&](int g, int s) {
        const uint32_t bar = smem_address(&sh.full[s]);
        mbar_expect_tx(bar, kStage);
        tc_load_boxes<Tier>(ring + s * kStage, &rmap, &cmap, bar, g % nk, row0,
                            (jt0 + g / nk) * kTcEdge);
    };
    if (tid == 0) {
        for (int s = 0; s < kTcStages && s < total; ++s) {
            load(s, s);
        }
    }

    // the V rows of classes [c0, c0 + cn) of the row tile and of the
    // column tile at col0
    auto stage = [&](int col0, int c0, int cn) {
        for (int e = tid; e < kTcEdge * cn; e += kTcThreads) {
            const int r = e / cn;
            const int cc = e % cn;
            const int gr = row0 + r;
            const int gc = col0 + r;
            sh.v_rows[cc][r] = gr < mr ? Vr[int64_t(gr) * C + c0 + cc] : 0.0f;
            sh.v_cols[cc][r] = gc < mc ? Vc[int64_t(gc) * C + c0 + cc] : 0.0f;
        }
    };

    const TcFragment f(tid);
    const int warp = tid / 32;
    const int lane = tid % 32;
    const bool row_ok[2] = {row0 + f.rl[0] < mr, row0 + f.rl[1] < mr};
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) {
        acc[i] = 0.0f;
    }
    for (int g = 0; g < total; ++g) {
        // a tile's first box overwrites the accumulators (scale-d 0)
        tc_consume<Tier>(acc, ring, sh.full, sh.empty, g, total, tid,
                         g % nk != 0, load);
        if (g % nk != nk - 1) {
            continue;
        }
        // the tile's last box: its epilogue, while the next tile's first
        // boxes load.  The previous tile's readers of sq_c and the V rows
        // finished before its last class's closing barrier.
        wgmma_wait<0>();
        fence_acc(acc);
        const int col0 = (jt0 + g / nk) * kTcEdge;
        if (tid < kTcEdge) {
            const int c = col0 + tid;
            sh.sq_c[tid] = c < mc ? sq_c[c] : 0.0f;
        }
        stage(col0, 0, C < kTcDualChunk ? C : kTcDualChunk);
        __syncthreads();
        tc_kernel_fragment<KIND>(acc, f, row_ok, sh.sq_r, sh.sq_c, col0, mc,
                                 degree, gamma, coef0);
        for (int c0 = 0; c0 < C; c0 += kTcDualChunk) {
            const int cn = C - c0 < kTcDualChunk ? C - c0 : kTcDualChunk;
            if (c0 > 0) {
                stage(col0, c0, cn);
                __syncthreads();
            }
            for (int cc = 0; cc < cn; ++cc) {
                const int c = c0 + cc;
                float rs[2];
                tc_row_sums(acc, sh.v_cols[cc], f.q, rs);
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    if (f.q == 0 && row_ok[h]) {
                        if (c < kTcDualRunClasses) {
                            sh.row_acc[c][f.rl[h]] += rs[h];
                        } else {
                            // this thread's own slot entry: the run's first
                            // tile writes it, the others add to it
                            float& dst = slot_r[int64_t(row0 + f.rl[h]) * C + c];
                            dst = g < nk ? rs[h] : dst + rs[h];
                        }
                    }
                }
                tc_col_sums(acc, sh.v_rows[cc][f.rl[0]], sh.v_rows[cc][f.rl[1]],
                            lane, sh.col_part[warp]);
                __syncthreads();
                if (tid < kTcEdge && col0 + tid < mc) {
                    float sum = 0.0f;
#pragma unroll
                    for (int w = 0; w < kTcWarps; ++w) {
                        sum += sh.col_part[w][tid];
                    }
                    slot_c[int64_t(col0 + tid) * C + c] = sum;
                }
                // col_part, and after a chunk's last class the V rows, are
                // written again
                __syncthreads();
            }
        }
    }

    // the run's row sums into the run's slot, one store per row and class;
    // the last class's closing barrier made them visible
    const int rc = C < kTcDualRunClasses ? C : kTcDualRunClasses;
    for (int e = tid; e < kTcEdge * rc; e += kTcThreads) {
        const int r = e / rc;
        const int c = e % rc;
        if (row0 + r < mr) {
            slot_r[int64_t(row0 + r) * C + c] = sh.row_acc[c][r];
        }
    }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The TMA descriptor of an operand copy X (m, d_pad), boxes of 128 rows x
// 128 bytes in the 128-byte swizzle, zero fill past the edges; for a
// split tier the 3-D map over the (2, m, d_pad) stack, boxes of one part,
// whose parts lie part_rows rows apart (m, or the whole stack's rows when
// X is a band of it).  cuTensorMapEncodeTiled comes through the runtime's
// entry-point query, so the library links the CUDA runtime alone (no
// -lcuda).
template <typename Tier>
cudaError_t encode_operand(CUtensorMap* map, const void* X, int64_t m,
                           int64_t d_pad, int64_t part_rows = -1) {
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
    constexpr cuuint32_t rank = Tier::kParts == 1 ? 2 : 3;
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d_pad),
                                static_cast<cuuint64_t>(m), 2};
    const cuuint64_t strides[2] = {
        static_cast<cuuint64_t>(d_pad) * Tier::kItemSize,
        static_cast<cuuint64_t>(part_rows < 0 ? m : part_rows) *
            static_cast<cuuint64_t>(d_pad) * Tier::kItemSize};
    const cuuint32_t box[3] = {static_cast<cuuint32_t>(Tier::kFeatures),
                               static_cast<cuuint32_t>(kTcEdge), 1};
    const cuuint32_t steps[3] = {1, 1, 1};
    const CUresult r = encode(
        map, Tier::kType, rank, const_cast<void*>(X), dims, strides, box, steps,
        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// What TMA takes of an operand copy: 16-byte alignment, a row of a
// multiple of 16 bytes, 32-bit coordinates.
template <typename Tier>
bool tma_operand_ok(const void* X, int64_t rows, int64_t d_pad) {
    return rows <= INT32_MAX && d_pad <= INT32_MAX &&
           d_pad % (16 / Tier::kItemSize) == 0 &&
           reinterpret_cast<uintptr_t>(X) % 16 == 0;
}

// The tensor-core kernels take kTcSmemBytes of dynamic shared memory (the
// split tier's sym and rect tiles tc_smem_bytes<Tf32x3Tier>()), more than
// the 48 KB a kernel gets without asking.
template <typename Kernel>
cudaError_t tc_allow_ring(Kernel kernel, int bytes = kTcSmemBytes) {
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                bytes);
}

// Kernels A (C = 1) and C on the symmetric tile, in the passes of
// sym_plan (column tiles in steps of kTcGroup, the raster's groups).
template <typename Tier, int KIND>
cudaError_t launch_tc_sym(const void* X, const float* sq, const float* V,
                          float* out, int64_t m, int64_t d_pad, int64_t C,
                          int degree, float gamma, float coef0,
                          const Workspace& workspace, cudaStream_t stream) {
    const int64_t nt = (m + kTcEdge - 1) / kTcEdge;
    const int64_t nk = (d_pad + Tier::kFeatures - 1) / Tier::kFeatures;
    if (nt <= 0 || C <= 0 || nk <= 0 || nk > INT32_MAX ||
        !tma_operand_ok<Tier>(X, m, d_pad)) {
        return cudaErrorInvalidValue;
    }
    CUtensorMap map;
    auto kernel = gram_tc_sym_kernel<Tier, KIND>;
    if (workspace.base != nullptr) {
        cudaError_t err = encode_operand<Tier>(&map, X, m, d_pad);
        if (err == cudaSuccess) {
            err = tc_allow_ring(kernel, tc_smem_bytes<Tier>());
        }
        if (err != cudaSuccess) {
            return err;
        }
    }
    return run_sym<float>(workspace, m, kTcEdge, kTcGroup, C, out, stream,
                          [&](const SymPass& pass, float* ws) {
        kernel<<<static_cast<unsigned int>(pass.blocks()), kTcThreads,
                 tc_smem_bytes<Tier>(), stream>>>(
            map, sq, V, ws, pass, m, C, static_cast<int>(nk), nt, degree,
            gamma, coef0);
        return cudaGetLastError();
    });
}

// The rect tile's run for ``tiles`` tiles: the longest, up to kTcMaxRun,
// that still leaves kTcRunWaves waves of blocks (``per_sm`` an SM).
inline cudaError_t tc_run_length(int64_t tiles, int per_sm, int64_t& run) {
    int device = 0;
    int sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) {
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     device);
    }
    if (err != cudaSuccess) {
        return err;
    }
    run = tiles / (int64_t(kTcRunWaves) * per_sm * sms);
    run = run < 1 ? 1 : (run > kTcMaxRun ? kTcMaxRun : run);
    return cudaSuccess;
}

// The runs a row tile of the rect and dual tiles walks over n_c columns,
// for n_r rows: the row partners of fixed_sum.cuh's slots (0 when the
// device cannot be asked).
template <typename Tier>
int64_t tc_runs(int64_t n_r, int64_t n_c) {
    const int64_t n_rt = (n_r + kTcEdge - 1) / kTcEdge;
    const int64_t n_ct = (n_c + kTcEdge - 1) / kTcEdge;
    int64_t run = 0;
    if (tc_run_length(n_rt * n_ct, Tier::kBlocksPerSm, run) != cudaSuccess) {
        return 0;
    }
    run = run < n_ct ? run : n_ct;
    return (n_ct + run - 1) / run;
}

// The grid of the rect and dual tiles over the n_r x n_c rectangle of rows
// R and columns S (the tier's operand copies; R a band of r_part_rows
// rows' split stack at "highest"): the tensor maps of both, nk boxes of
// features, runs of tc_run_length's length (at most the n_ct column
// tiles) and n_rt x ceil(n_ct / run) blocks.  Every count fits the
// kernels' 32-bit arguments.
struct TcRectGrid {
    CUtensorMap rmap;
    CUtensorMap cmap;
    int n_rt, n_ct, nk, run;
    unsigned int blocks;
};

template <typename Tier>
cudaError_t tc_rect_grid(const void* R, const void* S, int64_t n_r,
                         int64_t n_c, int64_t d_pad, int64_t C,
                         int64_t r_part_rows, TcRectGrid& grid) {
    const int64_t n_rt = (n_r + kTcEdge - 1) / kTcEdge;
    const int64_t n_ct = (n_c + kTcEdge - 1) / kTcEdge;
    const int64_t nk = (d_pad + Tier::kFeatures - 1) / Tier::kFeatures;
    if (n_rt <= 0 || n_ct <= 0 || C <= 0 || nk <= 0 ||
        !tma_operand_ok<Tier>(R, n_r, d_pad) ||
        !tma_operand_ok<Tier>(S, n_c, d_pad)) {
        return cudaErrorInvalidValue;
    }
    int64_t run = 0;
    cudaError_t err = tc_run_length(n_rt * n_ct, Tier::kBlocksPerSm, run);
    if (err != cudaSuccess) {
        return err;
    }
    run = run < n_ct ? run : n_ct;
    const int64_t blocks = n_rt * ((n_ct + run - 1) / run);
    if (blocks > INT32_MAX || run * nk > INT32_MAX || C > INT32_MAX) {
        return cudaErrorInvalidValue;
    }
    grid.n_rt = static_cast<int>(n_rt);
    grid.n_ct = static_cast<int>(n_ct);
    grid.nk = static_cast<int>(nk);
    grid.run = static_cast<int>(run);
    grid.blocks = static_cast<unsigned int>(blocks);
    err = encode_operand<Tier>(&grid.rmap, R, n_r, d_pad, r_part_rows);
    if (err == cudaSuccess) {
        err = encode_operand<Tier>(&grid.cmap, S, n_c, d_pad);
    }
    return err;
}

// Row ``row0`` of the tier's operand copy R (rows x d_pad).
template <typename Tier>
const void* tc_band(const void* R, int64_t row0, int64_t d_pad) {
    return static_cast<const uint8_t*>(R) + row0 * d_pad * Tier::kItemSize;
}

// Kernels B (C = 1) and D on the rect tile, in the row bands of run_rows.
template <typename Tier, int KIND>
cudaError_t launch_tc_rect(const void* P, const void* S, const float* sq_p,
                           const float* sq_s, const float* A, float* out,
                           int64_t n_p, int64_t n_s, int64_t d_pad, int64_t C,
                           int degree, float gamma, float coef0,
                           const Workspace& workspace, cudaStream_t stream) {
    if (n_p <= 0 || n_s <= 0 || C <= 0 || C > INT32_MAX) {
        return cudaErrorInvalidValue;
    }
    auto kernel = gram_tc_rect_kernel<Tier, KIND>;
    if (workspace.base != nullptr) {
        const cudaError_t err = tc_allow_ring(kernel, tc_smem_bytes<Tier>());
        if (err != cudaSuccess) {
            return err;
        }
    }
    return run_rows<float>(
        workspace, n_p, kTcEdge, C, 0, 1, out, nullptr, stream,
        [&](int64_t rows) { return tc_runs<Tier>(rows, n_s); },
        [&](int64_t row0, int64_t rows, float* ws, float*, int64_t ws_rows) {
            TcRectGrid grid;
            cudaError_t err = tc_rect_grid<Tier>(tc_band<Tier>(P, row0, d_pad),
                                                 S, rows, n_s, d_pad, C, n_p,
                                                 grid);
            if (err != cudaSuccess) {
                return err;
            }
            kernel<<<grid.blocks, kTcThreads, tc_smem_bytes<Tier>(), stream>>>(
                grid.rmap, grid.cmap, sq_p + row0, sq_s, A, ws,
                static_cast<int>(ws_rows), static_cast<int>(rows),
                static_cast<int>(n_s), static_cast<int>(C), grid.nk, grid.n_rt,
                grid.n_ct, grid.run, degree, gamma, coef0);
            return cudaGetLastError();
        });
}

// Kernels J (C = 1) and K on the dual tile: Xr (mr, d_pad) and Xc (mc,
// d_pad) the tier's operand copies, sq_r / sq_c the float32 operands'
// norms, Vc (mc, C) and Vr (mr, C) row-major; the sums are added to out_r
// (mr, C) and out_c (mc, C), in the row bands of run_rows.
template <typename Tier, int KIND>
cudaError_t launch_tc_dual(const void* Xr, const void* Xc, const float* sq_r,
                           const float* sq_c, const float* Vc, const float* Vr,
                           float* out_r, float* out_c, int64_t mr, int64_t mc,
                           int64_t d_pad, int64_t C, int degree, float gamma,
                           float coef0, const Workspace& workspace,
                           cudaStream_t stream) {
    if (mr <= 0 || mc <= 0 || C <= 0 || C > INT32_MAX) {
        return cudaErrorInvalidValue;
    }
    auto kernel = gram_tc_dual_kernel<Tier, KIND>;
    if (workspace.base != nullptr) {
        const cudaError_t err = tc_allow_ring(kernel, tc_smem_bytes<Tier>());
        if (err != cudaSuccess) {
            return err;
        }
    }
    return run_rows<float>(
        workspace, mr, kTcEdge, C, mc, 1, out_r, out_c, stream,
        [&](int64_t rows) { return tc_runs<Tier>(rows, mc); },
        [&](int64_t row0, int64_t rows, float* ws_r, float* ws_c,
            int64_t ws_rows) {
            TcRectGrid grid;
            cudaError_t err = tc_rect_grid<Tier>(tc_band<Tier>(Xr, row0, d_pad),
                                                 Xc, rows, mc, d_pad, C, mr,
                                                 grid);
            if (err != cudaSuccess) {
                return err;
            }
            kernel<<<grid.blocks, kTcThreads, tc_smem_bytes<Tier>(), stream>>>(
                grid.rmap, grid.cmap, sq_r + row0, sq_c, Vc, Vr + row0 * C,
                ws_r, ws_c, static_cast<int>(ws_rows), static_cast<int>(rows),
                static_cast<int>(mc), static_cast<int>(C), grid.nk, grid.n_rt,
                grid.n_ct, grid.run, degree, gamma, coef0);
            return cudaGetLastError();
        });
}

// How many blocks of the dual tile an SM holds at once (the tile is
// designed for Tier::kBlocksPerSm: two at the one-pass tiers, one at the
// split tier).
template <typename Tier, int KIND>
cudaError_t tc_dual_blocks_per_sm(int& blocks) {
    auto kernel = gram_tc_dual_kernel<Tier, KIND>;
    cudaError_t err = tc_allow_ring(kernel, tc_smem_bytes<Tier>());
    if (err != cudaSuccess) {
        return err;
    }
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, kTcThreads, tc_smem_bytes<Tier>());
}

// The entry points' dispatch: launch(Tier{}, kind constant) for the tier
// (bf16 or TF32) and the kernel function.
template <typename Tier, typename Launch>
int tc_dispatch_kind(int kind, const Launch& launch) {
    switch (kind) {
        case kPolynomial:
            return launch(Tier{}, std::integral_constant<int, kPolynomial>{});
        case kRbf:
            return launch(Tier{}, std::integral_constant<int, kRbf>{});
        case kSigmoid:
            return launch(Tier{}, std::integral_constant<int, kSigmoid>{});
        default:
            return cudaErrorInvalidValue;
    }
}

template <typename Launch>
int tc_dispatch(bool bf16, int kind, const Launch& launch) {
    return bf16 ? tc_dispatch_kind<Bf16Tier>(kind, launch)
                : tc_dispatch_kind<Tf32Tier>(kind, launch);
}

// The entry points' launches for their tier, dispatched on the kind.
// Templates, so that a source instantiates only the tiles it launches.
template <typename Tier>
int tc_sym(const void* X, const float* sq, const float* V, float* out,
           int64_t m, int64_t d_pad, int64_t C, int kind, int degree,
           float gamma, float coef0, const Workspace& ws, void* stream) {
    return tc_dispatch_kind<Tier>(kind, [&](auto tier, auto k) {
        return launch_tc_sym<decltype(tier), decltype(k)::value>(
            X, sq, V, out, m, d_pad, C, degree, gamma, coef0, ws,
            static_cast<cudaStream_t>(stream));
    });
}

template <typename Tier>
int tc_rect(const void* P, const void* S, const float* sq_p, const float* sq_s,
            const float* A, float* out, int64_t n_p, int64_t n_s,
            int64_t d_pad, int64_t C, int kind, int degree, float gamma,
            float coef0, const Workspace& ws, void* stream) {
    return tc_dispatch_kind<Tier>(kind, [&](auto tier, auto k) {
        return launch_tc_rect<decltype(tier), decltype(k)::value>(
            P, S, sq_p, sq_s, A, out, n_p, n_s, d_pad, C, degree, gamma, coef0,
            ws, static_cast<cudaStream_t>(stream));
    });
}

template <typename Tier>
int tc_dual(const void* Xr, const void* Xc, const float* sq_r,
            const float* sq_c, const float* Vc, const float* Vr, float* out_r,
            float* out_c, int64_t mr, int64_t mc, int64_t d_pad, int64_t C,
            int kind, int degree, float gamma, float coef0, const Workspace& ws,
            void* stream) {
    return tc_dispatch_kind<Tier>(kind, [&](auto tier, auto k) {
        return launch_tc_dual<decltype(tier), decltype(k)::value>(
            Xr, Xc, sq_r, sq_c, Vc, Vr, out_r, out_c, mr, mc, d_pad, C, degree,
            gamma, coef0, ws, static_cast<cudaStream_t>(stream));
    });
}

}  // namespace
