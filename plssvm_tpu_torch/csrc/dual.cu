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
// Kernels J (at "highest") and L, the matvec walks, run on a walk of
// their own (matvec_dual_kernel), written for the card's SM count, shared
// memory and asynchronous copies; K and M keep kernel B's 2-D grid over
// every BM x BM tile of the mr x mc block (matmat_dual_kernel).  Both
// evaluate every tile of the block, not kernel A's upper triangle: the
// block is not symmetric; both take the pair operation of the kind (the
// Gram product, or kernels E-H's laplacian and chi-squared terms with
// their per-type unroll, chunk sums and, for double chi-squared, the
// guard and the compensated sum of gram_tile.cuh, so per entry of K they
// round as kernels E-H do).
//
// The matvec walk.  The block's rows fall into row tiles of 16 RA rows and
// its columns into strips of 2 RB columns (WalkTile: RA x RB = 8 x 8 for
// the float Gram product and laplacian, 4 x 4 for chi-squared and the
// double laplacian); a unit is one strip of one row tile, numbered row
// tile major.  The grid is persistent, the card's SMs times the blocks an
// SM holds (fewer where there are fewer units), and block b takes units
// [b U / G, (b + 1) U / G): every block's run is within one unit of the
// others'.  A block walks its run in steps of up to 8 strips of one row
// tile, one strip a warp, or two warps a strip, each half its rows, in a
// step of 4 strips or fewer, so that no warp sits a step out.  Lane (lr,
// lc) of a warp holds rows and columns in runs of 16 bytes (walk_row,
// walk_col), so a thread reads a feature's values of its rows and columns
// with RA / kVec + RB / kVec 16-byte loads (4 for the float 8 x 8 tile,
// in place of 16 scalar loads beside its 128 FADDs a feature).  Each 16-feature
// chunk of the step's rows and columns is copied with cp.async (4 or 8
// bytes a value, transposed, zero-filled past mr, mc and d) into one of
// two stages while the other is computed, one barrier a chunk; the next
// step's first chunk lands while the last is computed.  The row sums stay
// in registers while a run stays on its row tile and go to the block's
// slot of the row tile once (through row_part; slot b - b0 for the first
// block b0 whose run reaches the row tile, at most walk_row_slots a tile,
// the rest zeroed); the column sums of a step are reduced over the warp's
// 16 row lanes by shuffles and stored in the slot of the row tile and the
// warp's half of it (two warps share a strip in a short step).  K and M:
// kernel C's class loop with both directions always on and the row and
// column bounds apart (dual_class_loop), row and column sums into slots
// for every tile.  fixed_sum.cuh adds the slots in order.  Both edges are
// masked, so nothing is padded; sizes are 64-bit.  Not carried over from
// the TPU: the 128-row padding, the class-major layout padded to 8, the
// resident column accumulator (the slots replace it).
//
// Tiers: the Gram matvec walk here serves J in float32 at "highest" (L and
// M serve every tier and both types).  On float32 data at "f32" (TF32) and
// "bf16", J and K run on the dual tensor-core tile of gram_tc.cuh
// (gram_tc_dual_kernel, instantiated here behind
// plssvm_gram_matvec_dual_tc_* / plssvm_gram_matmat_dual_tc_*), which takes
// the wrapper's operand copies of Xr and Xc (tier_operand) with the float32
// operands' norms; at "highest" K runs on the same tile in three TF32
// passes over the split stacks [hi; lo] of Xr and Xc
// (plssvm_gram_matmat_dual_tc_tf32x3), as A-D do on theirs, and J keeps its
// walk.  K's FFMA tile here (matmat_dual_kernel on the Gram product) is on
// no wrapper's path since then: gram_matvec.gram_ffma launches it for the
// card tests and chip_smoke.py's before-time.  Every product of a ring
// solve stays at its one tier.  In float64, at every tier, J and K run on
// the dual DMMA tile of gram_dmma.cu, as the ring's symmetric products
// (kernels A and C) run on its symmetric one, so the Gram walks here are
// compiled for float32 only.
//
// What bounds them: as kernels A-H, the pair operation on the CUDA cores,
// mr * mc * d pair evaluations (all of them, where A and E evaluate half
// the square), on the FP32 lanes (Gram, laplacian), the SFU (float
// chi-squared) or the FP64 pipe (float64 distances: chi-squared's
// divide-free quotient of ChiSquaredDistance, in gram_tile.cuh, on chunks
// whose values pass its guard).  The column sums cost one slot store per
// column and step (per class and tile in K and M) where A pays them off the
// diagonal only.
//
// Numerics: no fast-math, as kernels A-H.  Every sum across blocks is taken
// in an order fixed by the shapes and the grid (fixed_sum.cuh).

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

// ---------------------------------------------------------------------
// The matvec walk of kernels J (at "highest") and L (the header says how
// it splits the block).  Lane (lr, lc) = (lane % 16, lane / 16) of a warp
// is its row lane and column lane.

constexpr int kWalkWarps = 8;
constexpr int kWalkThreads = 32 * kWalkWarps;
constexpr int kStripLanes = 2;  // column lanes of a warp: a strip is 2 RB wide

// The register tile of a thread, kRows x kCols values of T, and the blocks
// an SM must hold (__launch_bounds__): 8 x 8 for the float Gram product and
// laplacian (two blocks an SM, at most 128 registers), 4 x 4 for the
// double laplacian (8 x 4 spilled at two blocks an SM and was slower at
// one) and for chi-squared (kernels E-H's 64-row tile, whose chunk
// partials and, in double, compensation and quotient take the registers;
// float chi-squared at three blocks an SM, as kernel G, is faster than at
// two, double chi-squared holds one).
template <typename T, int KIND>
struct WalkTile {
    static constexpr bool kFloat = std::is_same_v<T, float>;
    static constexpr bool kWide = kFloat && KIND != kChiSquared;
    static constexpr int kRows = kWide ? 8 : 4;
    static constexpr int kCols = kWide ? 8 : 4;
    static constexpr int kMinBlocks =
        KIND != kChiSquared ? 2 : (kFloat ? 3 : 1);
    // the feature loop's unroll on the wide float tile: 4 for the Gram
    // product (faster than 8 or 16 on an H100), 2 for the laplacian (as
    // fast as 4, which spilled); the pair operation's otherwise (float
    // chi-squared: 4 and 8 were slower than its 16)
    static constexpr int kUnroll =
        kWide ? (KIND == kLaplacian ? 2 : 4)
              : Dual<T, KIND>::Op::template kUnroll<T>;
};

// Values of T in 16 bytes: a thread's rows (and columns) lie in runs of
// kVec side by side in a stage, read with one 16-byte load each.
template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));

// Row a of the thread's tile (lr its row lane) and column b of its strip
// (lc its column lane): run a / kVec of the 16 row lanes' runs, and of
// the 2 column lanes'.
template <typename T>
__device__ __forceinline__ int walk_row(int a, int lr) {
    return a / kVec<T> * (kThreads * kVec<T>) + lr * kVec<T> + a % kVec<T>;
}
template <typename T>
__device__ __forceinline__ int walk_col(int b, int lc) {
    return b / kVec<T> * (kStripLanes * kVec<T>) + lc * kVec<T> + b % kVec<T>;
}

// dst[0 .. kVec) = src[0 .. kVec), src 16-byte aligned in shared memory
__device__ __forceinline__ void load16(const float* src, float* dst) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
}
__device__ __forceinline__ void load16(const double* src, double* dst) {
    const double2 v = *reinterpret_cast<const double2*>(src);
    dst[0] = v.x;
    dst[1] = v.y;
}

// One stage of the double buffer: feature chunk k0 .. k0 + kChunk - 1 of
// the step's row tile (x) and of its strips' columns (y), transposed; a
// row of the stage padded by 16 bytes, which keeps the runs aligned and
// spreads the copies' stores over the banks.
template <typename T, int RA, int RB>
struct alignas(16) WalkStage {
    T x[kChunk][kThreads * RA + kVec<T>];
    T y[kChunk][kWalkWarps * kStripLanes * RB + kVec<T>];
};

template <typename T, int RA, int RB>
struct WalkShared {
    WalkStage<T, RA, RB> stage[2];
    // each warp's row sums over the run's steps on the current row tile,
    // entry [w][r] written by one lane of warp w only
    T row_part[kWalkWarps][kThreads * RA];
};

// Global to shared memory without the registers (cp.async, cached in L1:
// the 16 threads copying a row's chunk read 16 values side by side); ok
// false writes zeros and reads nothing.
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src, bool ok) {
    static_assert(sizeof(T) == 4 || sizeof(T) == 8, "4- or 8-byte values");
    const unsigned int to =
        static_cast<unsigned int>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(to),
                 "l"(src), "n"(static_cast<int>(sizeof(T))),
                 "r"(ok ? static_cast<int>(sizeof(T)) : 0)
                 : "memory");
}
__device__ __forceinline__ void copy_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// this thread's copies have landed (visible to it; to the block after a
// barrier)
__device__ __forceinline__ void copy_async_wait() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A step of a block's run: strips strip0 .. strip0 + strips - 1 of one row
// tile, its first row row0 and column col0 = strip0 * SW; strips == 0
// past the run's end.
struct WalkStep {
    int64_t row0;
    int64_t col0;
    int strips;
};

// The end of block blockIdx.x's run: [U b / G, U (b + 1) / G) of the U
// units.
__device__ __forceinline__ int64_t walk_end(int64_t n_units) {
    return n_units * (blockIdx.x + 1) / gridDim.x;
}

// The block whose run holds unit u of U units over G blocks: the last b
// with U b / G <= u.
__host__ __device__ __forceinline__ int64_t walk_block(int64_t u, int64_t n_units,
                                                       int64_t grid) {
    return ((u + 1) * grid - 1) / n_units;
}

// This block's row slot of row tile ``tile``: its index among the blocks
// whose runs reach the tile (whose first unit is tile n_strips).
__device__ __forceinline__ int64_t walk_row_slot(int64_t tile, int64_t n_strips,
                                                 int64_t n_units) {
    return blockIdx.x - walk_block(tile * n_strips, n_units, gridDim.x);
}

// The row slots a row tile of the walk takes: the most blocks whose runs
// reach one row tile, over the n_tiles tiles of n_strips units each.
inline int64_t walk_row_slots(int64_t n_tiles, int64_t n_strips, int64_t grid) {
    const int64_t n_units = n_tiles * n_strips;
    int64_t most = 0;
    for (int64_t t = 0; t < n_tiles; ++t) {
        const int64_t blocks = walk_block((t + 1) * n_strips - 1, n_units, grid) -
                               walk_block(t * n_strips, n_units, grid) + 1;
        most = blocks > most ? blocks : most;
    }
    return most;
}

template <int BM, int SW>
__device__ __forceinline__ WalkStep walk_step(int64_t unit, int64_t end,
                                              int64_t n_strips) {
    WalkStep s{0, 0, 0};
    if (unit < end) {
        const int64_t tile = unit / n_strips;
        const int64_t strip0 = unit - tile * n_strips;
        int64_t n = n_strips - strip0;
        n = end - unit < n ? end - unit : n;
        s.strips = static_cast<int>(n < kWalkWarps ? n : kWalkWarps);
        s.row0 = tile * BM;
        s.col0 = strip0 * SW;
    }
    return s;
}

// The step after s in the block's run.
template <int BM, int SW>
__device__ __forceinline__ WalkStep walk_next(const WalkStep& s,
                                              int64_t n_strips,
                                              int64_t n_units) {
    const int64_t unit = s.row0 / BM * n_strips + s.col0 / SW + s.strips;
    return walk_step<BM, SW>(unit, walk_end(n_units), n_strips);
}

// The copies thread t makes in every chunk of a step: feature kk0 = t %
// kChunk of rows r0 + kRowStride i, r0 = t / kChunk, of the row tile (i <
// RA) and of the step's columns (i < y_rows); rows past mr / mc
// (i >= x_ok, i >= y_ok) and features past d land as 0.
constexpr int kRowStride = kWalkThreads / kChunk;  // 16 rows

// the number of i >= 0 with r0 + kRowStride i < n, at most cap
__device__ __forceinline__ int walk_count(int r0, int64_t n, int cap) {
    const int64_t c = n > r0 ? (n - r0 + kRowStride - 1) / kRowStride : 0;
    return static_cast<int>(c < cap ? c : cap);
}

// Start the copies of features k0 .. k0 + kChunk - 1 of step s into st.
template <typename T, int RA, int RB>
__device__ __forceinline__ void walk_stage(
    const T* __restrict__ Xr, const T* __restrict__ Xc, int64_t mr,
    int64_t mc, int64_t d, const WalkStep& s, int64_t k0,
    WalkStage<T, RA, RB>& st) {
    constexpr int SW = kStripLanes * RB;
    constexpr int kYMax = kWalkWarps * SW / kRowStride;
    const int r0 = threadIdx.x / kChunk;
    const int kk0 = threadIdx.x % kChunk;
    const bool in_d = k0 + kk0 < d;
    const int64_t stride = kRowStride * d;
    const int x_ok = walk_count(r0, mr - s.row0, RA);
    const int y_rows = walk_count(r0, int64_t(s.strips) * SW, kYMax);
    const int y_ok = walk_count(r0, mc - s.col0, y_rows);
    const T* x = Xr + (s.row0 + r0) * d + k0 + kk0;
    const T* y = Xc + (s.col0 + r0) * d + k0 + kk0;
#pragma unroll
    for (int i = 0; i < RA; ++i) {
        const bool ok = in_d && i < x_ok;
        copy_async(&st.x[kk0][r0 + kRowStride * i], ok ? x + i * stride : Xr, ok);
    }
#pragma unroll
    for (int i = 0; i < kYMax; ++i) {
        if (i < y_rows) {
            const bool ok = in_d && i < y_ok;
            copy_async(&st.y[kk0][r0 + kRowStride * i], ok ? y + i * stride : Xc,
                       ok);
        }
    }
}

// Whether every value this thread copied into st for a step of ``strips``
// strips passes Op's guard.
template <typename T, int RA, int RB, typename Op>
__device__ __forceinline__ bool walk_staged_in_range(
    const WalkStage<T, RA, RB>& st, int strips) {
    constexpr int SW = kStripLanes * RB;
    constexpr int kYMax = kWalkWarps * SW / kRowStride;
    const int r0 = threadIdx.x / kChunk;
    const int kk0 = threadIdx.x % kChunk;
    const int y_rows = walk_count(r0, int64_t(strips) * SW, kYMax);
    bool in_range = true;
#pragma unroll
    for (int i = 0; i < RA; ++i) {
        in_range &= Op::in_range(st.x[kk0][r0 + kRowStride * i]);
    }
#pragma unroll
    for (int i = 0; i < kYMax; ++i) {
        if (i < y_rows) {
            in_range &= Op::in_range(st.y[kk0][r0 + kRowStride * i]);
        }
    }
    return in_range;
}

// sums[a][b] += op(x, y) over the staged chunk for the rows a in [A0, A1)
// of the thread's tile, x its rows walk_row(a, lr) and y its columns col +
// walk_col(b, 0) of the stage (col the first of its strip's for its column
// lane), read in 16-byte runs; the feature loop unrolled by kUnroll.
template <typename T, int RA, int RB, typename Op, int kUnroll, int A0, int A1>
__device__ __forceinline__ void walk_pass(const WalkStage<T, RA, RB>& st,
                                          T (&sums)[RA][RB], int lr,
                                          int col) {
    constexpr int V = kVec<T>;
    static_assert(RA % V == 0 && RB % V == 0, "whole 16-byte runs");
#pragma unroll (kUnroll)
    for (int kk = 0; kk < kChunk; ++kk) {
        T xa[RA];
        T yb[RB];
#pragma unroll
        for (int a = A0 / V * V; a < A1; a += V) {  // the runs holding [A0, A1)
            load16(&st.x[kk][walk_row<T>(a, lr)], &xa[a]);
        }
#pragma unroll
        for (int b = 0; b < RB; b += V) {
            load16(&st.y[kk][col + walk_col<T>(b, 0)], &yb[b]);
        }
#pragma unroll
        for (int a = A0; a < A1; ++a) {
#pragma unroll
            for (int b = 0; b < RB; ++b) {
                Op::step(sums[a][b], xa[a], yb[b]);
            }
        }
    }
}

// walk_pass of Op on the thread's rows in a step whose strips have
// ``share`` warps each (1: all RA rows; 2: half of them, by ``half``), or of
// Op::Outside when Op is guarded on T and the chunk holds a value outside
// its range (in_range false in every thread).
template <typename T, int RA, int RB, typename Op, int kUnroll>
__device__ __forceinline__ void walk_rows_pass(const WalkStage<T, RA, RB>& st,
                                               T (&sums)[RA][RB], int lr,
                                               int col, int share, int half) {
    if (share == 1) {
        walk_pass<T, RA, RB, Op, kUnroll, 0, RA>(st, sums, lr, col);
    } else if (half == 0) {
        walk_pass<T, RA, RB, Op, kUnroll, 0, RA / 2>(st, sums, lr, col);
    } else {
        walk_pass<T, RA, RB, Op, kUnroll, RA / 2, RA>(st, sums, lr, col);
    }
}

template <typename T, int RA, int RB, typename Op, int kUnroll>
__device__ __forceinline__ void walk_op_pass(const WalkStage<T, RA, RB>& st,
                                             T (&sums)[RA][RB], int lr,
                                             int col, int share, int half,
                                             bool in_range) {
    if constexpr (Op::template kGuarded<T>) {
        if (!in_range) {
            using Outside = typename Op::Outside;
            walk_rows_pass<T, RA, RB, Outside, Outside::template kUnroll<T>>(
                st, sums, lr, col, share, half);
            return;
        }
    }
    walk_rows_pass<T, RA, RB, Op, kUnroll>(st, sums, lr, col, share, half);
}

template <typename T, int KIND>
__global__ void __launch_bounds__(kWalkThreads, WalkTile<T, KIND>::kMinBlocks)
    matvec_dual_kernel(const T* __restrict__ Xr, const T* __restrict__ Xc,
                       const T* __restrict__ sq_r, const T* __restrict__ sq_c,
                       const T* __restrict__ v_c, const T* __restrict__ v_r,
                       T* __restrict__ ws_r, T* __restrict__ ws_c,
                       int64_t ws_rows, int64_t mr, int64_t mc, int64_t d,
                       int64_t n_strips, int64_t n_units, int degree, T gamma,
                       T coef0) {
    using Op = typename Dual<T, KIND>::Op;
    constexpr int RA = WalkTile<T, KIND>::kRows;
    constexpr int RB = WalkTile<T, KIND>::kCols;
    constexpr int BM = kThreads * RA;
    constexpr int SW = kStripLanes * RB;
    __shared__ WalkShared<T, RA, RB> sh;

    const int warp = threadIdx.x / 32;
    const int lr = threadIdx.x % kThreads;
    const int lc = threadIdx.x % 32 / kThreads;
    WalkStep step = walk_step<BM, SW>(n_units * blockIdx.x / gridDim.x,
                                      walk_end(n_units), n_strips);
    if (step.strips == 0) {
        return;
    }
    const int n_chunks = static_cast<int>((d + kChunk - 1) / kChunk);
    walk_stage(Xr, Xc, mr, mc, d, step, 0, sh.stage[0]);
    copy_async_commit();
    for (int e = threadIdx.x; e < kWalkWarps * BM; e += kWalkThreads) {
        sh.row_part[e / BM][e % BM] = T(0);
    }
    __syncthreads();
    int buf = 0;
    while (true) {
        // a step of at most half the warps' strips gives each strip two
        // warps, each half of the rows, so that no warp sits it out
        const int share = 2 * step.strips <= kWalkWarps ? 2 : 1;
        const int half = warp % share;
        const bool active = warp / share < step.strips;
        // the first column of the thread's column lane in its strip
        const int col = warp / share * SW + lc * kVec<T>;
        T acc[RA][RB];
        // the compensated sum's running error, and whether it still runs:
        // only while every chunk so far passed Op's guard (as gram_tile)
        T comp[RA][RB];
        bool compensate = true;
#pragma unroll
        for (int a = 0; a < RA; ++a) {
#pragma unroll
            for (int b = 0; b < RB; ++b) {
                acc[a][b] = T(0);
                comp[a][b] = T(0);
            }
        }
        for (int c = 0; c < n_chunks; ++c) {
            copy_async_wait();
            // one barrier a chunk: chunk c is in stage buf for every thread,
            // and every thread is done reading stage buf ^ 1
            bool in_range = true;
            if constexpr (Op::template kGuarded<T>) {
                in_range = __syncthreads_and(walk_staged_in_range<T, RA, RB, Op>(
                               sh.stage[buf], step.strips)) != 0;
                compensate = compensate && in_range;
            } else {
                __syncthreads();
            }
            // the next chunk, or the next step's first, lands while this
            // one is computed
            if (c + 1 < n_chunks) {
                walk_stage(Xr, Xc, mr, mc, d, step, int64_t(c + 1) * kChunk,
                           sh.stage[buf ^ 1]);
            } else {
                const WalkStep next = walk_next<BM, SW>(step, n_strips, n_units);
                if (next.strips != 0) {
                    walk_stage(Xr, Xc, mr, mc, d, next, 0, sh.stage[buf ^ 1]);
                }
            }
            copy_async_commit();
            if (active) {
                if constexpr (Op::template kChunkSums<T>) {
                    T part[RA][RB];
#pragma unroll
                    for (int a = 0; a < RA; ++a) {
#pragma unroll
                        for (int b = 0; b < RB; ++b) {
                            part[a][b] = T(0);
                        }
                    }
                    walk_op_pass<T, RA, RB, Op, WalkTile<T, KIND>::kUnroll>(
                        sh.stage[buf], part, lr, col, share, half, in_range);
#pragma unroll
                    for (int a = 0; a < RA; ++a) {
#pragma unroll
                        for (int b = 0; b < RB; ++b) {
                            if (Op::template kCompensated<T> && compensate) {
                                const T y = part[a][b] - comp[a][b];
                                const T t = acc[a][b] + y;
                                comp[a][b] = (t - acc[a][b]) - y;
                                acc[a][b] = t;
                            } else {
                                acc[a][b] += part[a][b];
                            }
                        }
                    }
                } else {
                    walk_op_pass<T, RA, RB, Op, WalkTile<T, KIND>::kUnroll>(
                        sh.stage[buf], acc, lr, col, share, half, in_range);
                }
            }
            buf ^= 1;
        }
        if (active) {
            // the step's kernel values of the thread's rows (both halves, or
            // its half of a shared strip): into the row sums, which add up
            // in row_part while the run stays on this row tile, and into
            // the columns' sums, reduced over the warp's 16 row lanes and
            // stored by lane lr == b of each column lane in the slot of the
            // row tile and the warp's half (a strip of one warp also
            // stores the other half's 0).  A row past mr or a column past
            // mc (zero-filled, so its values are finite) has a weight of 0
            // and is never stored.
            T w_r[RA];
            T sq_a[RA];
            T row_sum[RA];
#pragma unroll
            for (int a = 0; a < RA; ++a) {
                const int64_t r = step.row0 + walk_row<T>(a, lr);
                w_r[a] = r < mr ? v_r[r] : T(0);
                sq_a[a] = T(0);
                if constexpr (!kIsDistance<KIND>) {
                    sq_a[a] = r < mr ? sq_r[r] : T(0);
                }
                row_sum[a] = T(0);
            }
#pragma unroll
            for (int b = 0; b < RB; ++b) {
                const int64_t j = step.col0 + col + walk_col<T>(b, 0);
                const bool col_ok = j < mc;
                const T w_c = col_ok ? v_c[j] : T(0);
                T sq_b = T(0);
                if constexpr (!kIsDistance<KIND>) {
                    sq_b = col_ok ? sq_c[j] : T(0);
                }
                T col_sum = T(0);
#pragma unroll
                for (int a = 0; a < RA; ++a) {
                    if (share == 1 || a / (RA / 2) == half) {
                        const T kval = dual_value<T, KIND>(acc[a][b], sq_a[a], sq_b,
                                                           gamma, coef0, degree);
                        row_sum[a] += kval * w_c;
                        col_sum += kval * w_r[a];
                    }
                }
                col_sum = half_warp_sum(col_sum);
                if (lr == b && col_ok) {
                    T* slot = ws_c + (2 * (step.row0 / BM) + half) * mc + j;
                    *slot = col_sum;
                    if (share == 1) {
                        slot[mc] = T(0);
                    }
                }
            }
#pragma unroll
            for (int a = 0; a < RA; ++a) {
                const T both = row_sum[a] + __shfl_xor_sync(0xffffffffu,
                                                            row_sum[a], 16);
                if (lc == 0) {
                    sh.row_part[warp][walk_row<T>(a, lr)] += both;
                }
            }
        }
        const WalkStep next = walk_next<BM, SW>(step, n_strips, n_units);
        if (next.strips == 0 || next.row0 != step.row0) {
            // the run leaves the row tile: the eight warps' row sums into
            // the block's slot of the row tile, and row_part back to 0
            __syncthreads();
            T* slot = ws_r + walk_row_slot(step.row0 / BM, n_strips, n_units) * ws_rows;
            for (int r = threadIdx.x; r < BM; r += kWalkThreads) {
                T total = T(0);
#pragma unroll
                for (int w = 0; w < kWalkWarps; ++w) {
                    total += sh.row_part[w][r];
                    sh.row_part[w][r] = T(0);
                }
                if (step.row0 + r < mr) {
                    slot[step.row0 + r] = total;
                }
            }
            __syncthreads();  // row_part is added to again from the next step
        }
        if (next.strips == 0) {
            copy_async_wait();  // none in flight but where d == 0
            return;
        }
        step = next;
    }
}

// The walk's grid on the current device: its SMs times the blocks of the
// instantiation an SM holds, asked once per device and kept.
template <typename T, int KIND>
cudaError_t walk_slots(int64_t& slots) {
    constexpr int kDevices = 64;
    static int sms[kDevices];
    static int per_sm[kDevices];
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) {
        return err;
    }
    int n_sms = device < kDevices ? sms[device] : 0;
    int n_per_sm = device < kDevices ? per_sm[device] : 0;
    if (n_per_sm <= 0) {
        err = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount,
                                     device);
        if (err == cudaSuccess) {
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &n_per_sm, matvec_dual_kernel<T, KIND>, kWalkThreads, 0);
        }
        if (err != cudaSuccess) {
            return err;
        }
        if (n_per_sm <= 0) {
            return cudaErrorInvalidConfiguration;
        }
        if (device < kDevices) {
            sms[device] = n_sms;
            per_sm[device] = n_per_sm;
        }
    }
    slots = int64_t(n_sms) * n_per_sm;
    return cudaSuccess;
}

// The class loop of the dual block matmats (kernels K and M): with the
// kernel tile kv of tile (it, jt) in registers, the partials sum_j kv[r][j]
// Vc[j, c] of the tile's rows into ws_r[(jt ws_rows + r) C + c] and sum_r
// kv[r][j] Vr[r, c] of its columns into ws_c[(it mc + j) C + c], for every
// class c (fixed_sum.cuh run_rows).  Vc (mc, C) and Vr (mr, C) are
// row-major; the V rows of both tiles are staged kClassChunk classes at a
// time in v_cols / v_rows, the column partials reduced through col_part.
// Kernel C's sym_class_loop with the column sums on for every tile and the
// row and column bounds apart.
template <typename T, int BM>
__device__ __forceinline__ void dual_class_loop(
    const T (&kv)[BM / kThreads][BM / kThreads], const T* __restrict__ Vc,
    const T* __restrict__ Vr, T* __restrict__ ws_r, T* __restrict__ ws_c,
    int64_t ws_rows, int64_t mr, int64_t mc, int64_t C, int64_t row0,
    int64_t col0, T (*v_cols)[BM + 1], T (*v_rows)[BM + 1], T (*col_part)[BM]) {
    constexpr int R = BM / kThreads;
    const int tx = threadIdx.x;
    const int ty = threadIdx.y;
    const int tid = ty * kThreads + tx;
    T* const slot_r = ws_r + (col0 / BM) * ws_rows * C;
    T* const slot_c = ws_c + (row0 / BM) * mc * C;
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
                    slot_r[r * C + c] = total;
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
                    slot_c[(col0 + j) * C + c] = total;
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
                       T* __restrict__ ws_r, T* __restrict__ ws_c,
                       int64_t ws_rows, int64_t mr, int64_t mc, int64_t d,
                       int64_t C, int64_t n_ctiles, int degree, T gamma,
                       T coef0) {
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
    dual_class_loop<T, BM>(kv, Vc, Vr, ws_r, ws_c, ws_rows, mr, mc, C, row0,
                           col0, v_cols, v_rows, col_part);
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

// Kernels J and L: the persistent grid of matvec_dual_kernel, the SMs
// times the blocks an SM holds, or one block a unit where there are fewer
// units, in the row bands of run_rows; each band's row slots are zeroed
// first, as a tile reached by fewer blocks than walk_row_slots leaves some
// unwritten.
template <typename T, bool kDistance>
int matvec_dual(const T* Xr, const T* Xc, const T* sq_r,
                const T* sq_c, const T* v_c, const T* v_r, T* out_r,
                T* out_c, int64_t mr, int64_t mc, int64_t d, int kind,
                int degree, T gamma, T coef0, const Workspace& workspace,
                void* stream) {
    return by_kind<kDistance>(kind, [&](auto k) {
        constexpr int KIND = decltype(k)::value;
        using Tile = WalkTile<T, KIND>;
        constexpr int BM = kThreads * Tile::kRows;
        constexpr int SW = kStripLanes * Tile::kCols;
        if (mr <= 0 || mc <= 0 || d < 0) {
            return static_cast<int>(cudaErrorInvalidValue);
        }
        const cudaStream_t s = static_cast<cudaStream_t>(stream);
        const int64_t n_strips = (mc + SW - 1) / SW;
        int64_t slots = 0;
        const cudaError_t err = walk_slots<T, KIND>(slots);
        if (err != cudaSuccess) {
            return static_cast<int>(err);
        }
        const auto grid = [&](int64_t rows) {
            const int64_t n_units = ((rows + BM - 1) / BM) * n_strips;
            return n_units < slots ? n_units : slots;
        };
        const auto row_slots = [&](int64_t rows) {
            return walk_row_slots((rows + BM - 1) / BM, n_strips, grid(rows));
        };
        // the column slots: two a row tile (the warps' halves)
        return static_cast<int>(run_rows<T>(
            workspace, mr, BM, 1, mc, 2, out_r, out_c, s, row_slots,
            [&](int64_t row0, int64_t rows, T* ws_r, T* ws_c, int64_t ws_rows) {
                const int64_t n_units = ((rows + BM - 1) / BM) * n_strips;
                cudaError_t e = cudaMemsetAsync(
                    ws_r, 0, sizeof(T) * row_slots(rows) * ws_rows, s);
                if (e != cudaSuccess) {
                    return e;
                }
                matvec_dual_kernel<T, KIND>
                    <<<static_cast<unsigned int>(grid(rows)), kWalkThreads, 0,
                       s>>>(Xr + row0 * d, Xc, sq_r == nullptr ? nullptr : sq_r + row0,
                            sq_c, v_c, v_r + row0, ws_r, ws_c, ws_rows, rows, mc,
                            d, n_strips, n_units, degree, gamma, coef0);
                return cudaGetLastError();
            }));
    });
}

template <typename T, bool kDistance>
int matmat_dual(const T* Xr, const T* Xc, const T* sq_r,
                const T* sq_c, const T* Vc, const T* Vr, T* out_r, T* out_c,
                int64_t mr, int64_t mc, int64_t d, int64_t C, int kind,
                int degree, T gamma, T coef0, const Workspace& workspace,
                void* stream) {
    return by_kind<kDistance>(kind, [&](auto k) {
        constexpr int KIND = decltype(k)::value;
        constexpr int BM = Dual<T, KIND>::kEdge;
        if (mr <= 0 || mc <= 0 || d < 0 || C <= 0) {
            return static_cast<int>(cudaErrorInvalidValue);
        }
        const cudaStream_t s = static_cast<cudaStream_t>(stream);
        const int64_t n_ctiles = (mc + BM - 1) / BM;
        return static_cast<int>(run_rows<T>(
            workspace, mr, BM, C, mc, 1, out_r, out_c, s,
            [&](int64_t) { return n_ctiles; },
            [&](int64_t row0, int64_t rows, T* ws_r, T* ws_c, int64_t ws_rows) {
                const int64_t blocks = ((rows + BM - 1) / BM) * n_ctiles;
                if (blocks > INT32_MAX) {
                    return cudaErrorInvalidValue;
                }
                matmat_dual_kernel<T, KIND>
                    <<<static_cast<unsigned int>(blocks),
                       dim3(kThreads, kThreads), 0, s>>>(
                        Xr + row0 * d, Xc, sq_r == nullptr ? nullptr : sq_r + row0,
                        sq_c, Vc, Vr + row0 * C, ws_r, ws_c, ws_rows, rows, mc,
                        d, C, n_ctiles, degree, gamma, coef0);
                return cudaGetLastError();
            }));
    });
}

}  // namespace

// The C interface: every entry point returns the cudaError_t of its
// launches (0 on success).  out_r (mr or mr x C) and out_c (mc or mc x C)
// must hold zeros: the sums are added to them.  workspace holds
// *workspace_bytes bytes; a null workspace asks for the bytes the call
// needs, written to *workspace_bytes, and launches nothing (fixed_sum.cuh).
// The Gram entry points take kind 1-3, the distance ones 4-5
// (KernelFunctionType's values).

extern "C" int plssvm_gram_matvec_dual_f32(
    const float* Xr, const float* Xc, const float* sq_r, const float* sq_c,
    const float* v_c, const float* v_r, float* out_r, float* out_c,
    int64_t mr, int64_t mc, int64_t d, int kind, int degree, float gamma,
    float coef0, void* workspace,
    int64_t* workspace_bytes, void* stream) {
    return matvec_dual<float, false>(Xr, Xc, sq_r, sq_c, v_c, v_r, out_r,
                                     out_c, mr, mc, d, kind, degree, gamma,
                                     coef0, Workspace{workspace, workspace_bytes},
                                     stream);
}

extern "C" int plssvm_gram_matmat_dual_f32(
    const float* Xr, const float* Xc, const float* sq_r, const float* sq_c,
    const float* Vc, const float* Vr, float* out_r, float* out_c,
    int64_t mr, int64_t mc, int64_t d, int64_t C, int kind, int degree,
    float gamma, float coef0, void* workspace,
    int64_t* workspace_bytes, void* stream) {
    return matmat_dual<float, false>(Xr, Xc, sq_r, sq_c, Vc, Vr, out_r,
                                     out_c, mr, mc, d, C, kind, degree, gamma,
                                     coef0, Workspace{workspace, workspace_bytes},
                                     stream);
}

// The distance entry points take no squared norms.
extern "C" int plssvm_distance_matvec_dual_f32(
    const float* Xr, const float* Xc, const float* v_c, const float* v_r,
    float* out_r, float* out_c, int64_t mr, int64_t mc, int64_t d, int kind,
    float gamma, void* workspace,
    int64_t* workspace_bytes, void* stream) {
    return matvec_dual<float, true>(Xr, Xc, nullptr, nullptr, v_c, v_r,
                                    out_r, out_c, mr, mc, d, kind, 0, gamma,
                                    0.0f, Workspace{workspace, workspace_bytes},
                                    stream);
}

extern "C" int plssvm_distance_matvec_dual_f64(
    const double* Xr, const double* Xc, const double* v_c, const double* v_r,
    double* out_r, double* out_c, int64_t mr, int64_t mc, int64_t d,
    int kind, double gamma, void* workspace,
    int64_t* workspace_bytes, void* stream) {
    return matvec_dual<double, true>(Xr, Xc, nullptr, nullptr, v_c, v_r,
                                     out_r, out_c, mr, mc, d, kind, 0, gamma,
                                     0.0, Workspace{workspace, workspace_bytes},
                                     stream);
}

extern "C" int plssvm_distance_matmat_dual_f32(
    const float* Xr, const float* Xc, const float* Vc, const float* Vr,
    float* out_r, float* out_c, int64_t mr, int64_t mc, int64_t d, int64_t C,
    int kind, float gamma, void* workspace,
    int64_t* workspace_bytes, void* stream) {
    return matmat_dual<float, true>(Xr, Xc, nullptr, nullptr, Vc, Vr, out_r,
                                    out_c, mr, mc, d, C, kind, 0, gamma, 0.0f,
                                    Workspace{workspace, workspace_bytes},
                                    stream);
}

extern "C" int plssvm_distance_matmat_dual_f64(
    const double* Xr, const double* Xc, const double* Vc, const double* Vr,
    double* out_r, double* out_c, int64_t mr, int64_t mc, int64_t d,
    int64_t C, int kind, double gamma, void* workspace,
    int64_t* workspace_bytes, void* stream) {
    return matmat_dual<double, true>(Xr, Xc, nullptr, nullptr, Vc, Vr, out_r,
                                     out_c, mr, mc, d, C, kind, 0, gamma, 0.0,
                                     Workspace{workspace, workspace_bytes},
                                     stream);
}

// Kernels J and K on the dual tensor-core tile (gram_tc.cuh): Xr and Xc the
// tier's operand copies (mr, d_pad) and (mc, d_pad), TF32-rounded float32 or
// bf16; sq_r, sq_c the float32 operands' norms.
extern "C" int plssvm_gram_matvec_dual_tc_tf32(
    const void* Xr, const void* Xc, const float* sq_r, const float* sq_c,
    const float* v_c, const float* v_r, float* out_r, float* out_c,
    int64_t mr, int64_t mc, int64_t d_pad, int kind, int degree, float gamma,
    float coef0, void* workspace,
    int64_t* workspace_bytes, void* stream) {
    return tc_dual<Tf32Tier>(Xr, Xc, sq_r, sq_c, v_c, v_r, out_r, out_c, mr, mc,
                             d_pad, 1, kind, degree, gamma, coef0,
        Workspace{workspace, workspace_bytes}, stream);
}

extern "C" int plssvm_gram_matvec_dual_tc_bf16(
    const void* Xr, const void* Xc, const float* sq_r, const float* sq_c,
    const float* v_c, const float* v_r, float* out_r, float* out_c,
    int64_t mr, int64_t mc, int64_t d_pad, int kind, int degree, float gamma,
    float coef0, void* workspace,
    int64_t* workspace_bytes, void* stream) {
    return tc_dual<Bf16Tier>(Xr, Xc, sq_r, sq_c, v_c, v_r, out_r, out_c, mr, mc,
                             d_pad, 1, kind, degree, gamma, coef0,
        Workspace{workspace, workspace_bytes}, stream);
}

extern "C" int plssvm_gram_matmat_dual_tc_tf32(
    const void* Xr, const void* Xc, const float* sq_r, const float* sq_c,
    const float* Vc, const float* Vr, float* out_r, float* out_c,
    int64_t mr, int64_t mc, int64_t d_pad, int64_t C, int kind, int degree,
    float gamma, float coef0, void* workspace,
    int64_t* workspace_bytes, void* stream) {
    return tc_dual<Tf32Tier>(Xr, Xc, sq_r, sq_c, Vc, Vr, out_r, out_c, mr, mc,
                             d_pad, C, kind, degree, gamma, coef0,
        Workspace{workspace, workspace_bytes}, stream);
}

extern "C" int plssvm_gram_matmat_dual_tc_bf16(
    const void* Xr, const void* Xc, const float* sq_r, const float* sq_c,
    const float* Vc, const float* Vr, float* out_r, float* out_c,
    int64_t mr, int64_t mc, int64_t d_pad, int64_t C, int kind, int degree,
    float gamma, float coef0, void* workspace,
    int64_t* workspace_bytes, void* stream) {
    return tc_dual<Bf16Tier>(Xr, Xc, sq_r, sq_c, Vc, Vr, out_r, out_c, mr, mc,
                             d_pad, C, kind, degree, gamma, coef0,
        Workspace{workspace, workspace_bytes}, stream);
}

// Kernel K at "highest" on the dual tile in three TF32 passes: Xr and Xc the
// split stacks (2, mr, d_pad) and (2, mc, d_pad) of tier_operand, the same
// parameters as the TF32 entry.
extern "C" int plssvm_gram_matmat_dual_tc_tf32x3(
    const void* Xr, const void* Xc, const float* sq_r, const float* sq_c,
    const float* Vc, const float* Vr, float* out_r, float* out_c,
    int64_t mr, int64_t mc, int64_t d_pad, int64_t C, int kind, int degree,
    float gamma, float coef0, void* workspace,
    int64_t* workspace_bytes, void* stream) {
    return tc_dual<Tf32x3Tier>(Xr, Xc, sq_r, sq_c, Vc, Vr, out_r, out_c, mr, mc,
                               d_pad, C, kind, degree, gamma, coef0,
        Workspace{workspace, workspace_bytes}, stream);
}

// Blocks of the dual tensor-core tile an SM holds at once, for the tier (0
// TF32, 1 bf16, 2 the split tier) and kind, into *blocks; returns the
// query's cudaError_t.
extern "C" int plssvm_gram_dual_tc_blocks_per_sm(int tier, int kind,
                                                 int* blocks) {
    const auto query = [&](auto t, auto k) {
        return static_cast<int>(
            tc_dual_blocks_per_sm<decltype(t), decltype(k)::value>(*blocks));
    };
    return tier == 2 ? tc_dispatch_kind<Tf32x3Tier>(kind, query)
                     : tc_dispatch(tier == 1, kind, query);
}

// Blocks of the matvec walk (kernels J at "highest" and L) an SM holds at
// once, for the type (f64: double, laplacian and chi-squared only) and
// kind, into *blocks; returns the query's cudaError_t.
extern "C" int plssvm_dual_walk_blocks_per_sm(int f64, int kind, int* blocks) {
    const auto query = [&](auto t, auto k) {
        return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            blocks, matvec_dual_kernel<decltype(t), decltype(k)::value>,
            kWalkThreads, 0));
    };
    if (f64 != 0) {
        return by_kind<true>(kind, [&](auto k) { return query(0.0, k); });
    }
    const auto single = [&](auto k) { return query(0.0f, k); };
    return kind == kLaplacian || kind == kChiSquared ? by_kind<true>(kind, single)
                                                      : by_kind<false>(kind, single);
}
