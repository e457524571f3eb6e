// The FP64 tensor-core Gram tiles of kernels A-D, J and K in float64, on
// the H100's double-precision tensor cores (DMMA, mma.sync ... .f64), at
// every Gram precision tier: DMMA multiplies and accumulates in IEEE
// float64, so only the summation order differs from the FFMA tiles'.
//
// - The symmetric tile (gram_dmma_sym_kernel): K(X, X) @ V for V (m, C),
//   C = 1 for kernel A.  Replaces, in float64, the Pallas kernels of
//   plssvm_tpu/ops/pallas_matvec.py kernel_matvec_pallas_dual (K1) and
//   kernel_matmat_pallas_dual (K4) with symmetric=True (and the chunk
//   compositions kernel_matvec_pallas_big / kernel_matmat_pallas_big: sizes
//   are 64-bit, one launch covers any m).
// - The dual tile (gram_dmma_dual_kernel): (K(Xr, Xc) @ Vc, K(Xr, Xc)^T @
//   Vr), one walk of an off-diagonal block of the row-sharded ring
//   (parallel/sharded.py), C = 1 for kernel J.  Replaces, in float64, K1 and
//   K4 with symmetric=False: the ring's cross_dual
//   (plssvm_tpu/parallel/sharded.py).
// - The rect tile (gram_dmma_rect_kernel): K(P, S) @ A, rows only, C = 1
//   for kernel B: predict against the support vectors and the ring's
//   rows-only walk of the antipodal block.  Replaces, in float64,
//   kernel_matvec_pallas_rect (K3) and the first output of K4 with
//   symmetric=False: plssvm_tpu's XLA predict_values and its ring's
//   cross_rows.
//
// The TPU has no float64 unit, so no float64 Pallas kernel exists and
// plssvm_tpu downcasts on the chip; the float64 functions the JAX package
// runs are kernel_matvec_xla (plssvm_tpu/ops/matvec.py), its predict and
// its ring's XLA block products.  The tiles replace the FFMA register tiles
// in float64 (gram_matvec.cu, gram_matmat.cu and the walks of dual.cu
// compile their Gram kinds for float32 only).  This source holds the tiles
// and their entry points, so each kernel function is compiled once.
//
// What bounds it on an H100: the pair work, 2 * pairs * d flops, at the
// FP64 tensor cores' 67 TFLOP/s, twice the FP64 CUDA cores' 34 TFLOP/s
// (17 T DFMA/s) on which the FFMA tile runs.  Beside it the FP64 pipe
// runs the epilogue: one exp (RBF) or power per pair and the contraction,
// 2 DFMAs per pair and class.  A 128 x 128 tile does 16 flops per operand
// byte it stages, so at the DMMA rate the blocks in flight want about 4
// TB/s from L2: the operand feed is the second limit.  What the design
// does about them:
//
// - The product: mma.sync.aligned.m16n8k4.row.col.f64 (wgmma has no f64
//   form).  Eight warps of 64 x 32 each (two warps down, four across the
//   128 x 128 tile), 4 x 4 m16n8 accumulators, 64 doubles a thread; one
//   block an SM (the accumulators alone take 128 registers).
// - The feed: TMA copies boxes of 128 rows x 16 doubles (128 bytes) of the
//   row and the column tile into a ring of kDmStages stages in the 128-byte
//   swizzle, counted by mbarriers, zero-filling rows past m and features
//   past d; thread 0 refills a stage once every thread has released it,
//   kDmStages - 1 boxes ahead of the product.  TMA needs a row of a
//   multiple of 16 bytes, so an odd d takes a copy padded with one zero
//   feature (ops/gram_matvec.py dmma_operand).
// - The fragments: the k index of an m16n8k4 product is a free
//   permutation of the features, as long as A and B agree.  In product p
//   of a box lane (g, t) (g = lane / 4, t = lane % 4) takes feature 2p +
//   8 (t / 2) + t % 2 for its k position t (dmma_offset), one 8-byte load
//   per fragment element: the 16 lanes of a half warp then read 16
//   different 8-byte words of the 128-byte swizzle's banks, no conflict,
//   and a warp issues 96 shared-memory wavefronts per box for 64 DMMAs.
//   Three layouts were timed on an H100 (PERF.md): this one; the
//   natural order, feature 4p + t, with 2-way bank conflicts, as fast
//   (64.1-64.7 against 64.3-64.7 ms for C at 59999 x 784, C = 10); and
//   features 4t .. 4t + 3 per lane as two 16-byte loads for two products
//   each, conflict-free too but 8 % slower (69.8 ms): its fragments for
//   two products at once took 230 registers against 204.  So at one block
//   an SM the banks are not what bounds the tile; the fragments' registers
//   and the loads' latency between products come first.
// - The symmetric walk: the upper triangle of 128 x 128 tiles in the raster
//   of the TF32 tile (grouped_upper_tile, gram_tc.cuh); the diagonal tile
//   contributes rows only.
// - The epilogue: the kernel function in float64 from the squared norms,
//   as the FFMA tile's apply_kernel.  Then per class, in exact DFMA as the
//   TPU kernel's contractions, the classes of both tiles' V rows staged
//   kClassChunk at a time: row partials reduced over the four lanes of a
//   row (a reduce-scatter: each lane keeps two rows) and over the four
//   warps across through shared memory; column partials reduced over the
//   eight row groups of a warp (a reduce-scatter butterfly, 7 shuffles)
//   and over the two warps down through shared memory; one slot store per
//   row and class, and off the diagonal one per column and class, each
//   slot of its partner tile, summed in partner order by fixed_sum.cuh.  The partial buffers alternate between classes, so a class
//   costs one barrier.  A second MMA for the class contraction is untried.
// - The dual tile: the same product, fragments, ring and epilogue (shared
//   device functions: dmma_tile_product, dmma_box, dmma_kernel_values,
//   dmma_row_partials, dmma_col_partials), with two tensor maps, one for Xr
//   and one for Xc, a
//   stage holding a box of each.  Its walk covers every tile of the n_rt x
//   n_ct block, grouped by row tiles as the TF32 dual tile's
//   (grouped_rect_run, gram_tc.cuh), so consecutive blocks share their
//   column tiles' boxes in L2 (at MNIST's width a ring block's Xc is 94
//   MB, more than L2 holds).  A block takes one tile (runs of 2-8 column
//   tiles a block, their row sums kept in shared memory, were no faster
//   at the ring's blocks on an H100; PERF.md).  Rows are masked against
//   mr, columns against mc; every tile takes the off-diagonal epilogue:
//   row partials against Vc, column partials against Vr, one slot store
//   per row and class and one per column and class.  What bounds it is the
//   symmetric tile's pair work, on every pair of the block instead of
//   half.  The kernel values come before the class loop, as in the
//   symmetric tile: computed inside it, their exps' temporaries added to
//   the class loop's registers and the tile spilled 272-460 bytes.
// - The rect tile: the dual tile's walk, product and row side, without the
//   column partials, their V staging and their slots: rows masked
//   against n_p, columns against n_s, per class the row partials against
//   the SV tile's weights and one slot store per row.  One tile a block, as
//   the dual tile.  The product loop is one device function of the three
//   tiles (dmma_tile_product); sharing it left the sym and dual tiles'
//   registers, spills and shared memory as they were (chip_smoke.py
//   --compare-build).  The pieces the tiles share live in gram_dmma.cuh,
//   which kernel O's float64 walk (pairs_tc.cu) is built from too.

#include "gram_dmma.cuh"

namespace {

// The partials of out[r, c] = sum_j k(x_r, x_j) V[j, c] over the tiles of
// one pass of the upper triangle (fixed_sum.cuh SymPass), columns mirrored
// off the diagonal, into their slots of ws; X arrives through xmap (m rows,
// its feature axis a multiple of 2), nk boxes of features.
template <int KIND>
__global__ void __launch_bounds__(kDmThreads, 1)
    gram_dmma_sym_kernel(const __grid_constant__ CUtensorMap xmap,
                         const double* __restrict__ sq,
                         const double* __restrict__ V,
                         double* __restrict__ ws, const SymPass pass,
                         int64_t m, int64_t C, int nk, int64_t nt, int degree,
                         double gamma, double coef0) {
    extern __shared__ uint8_t dm_ring[];
    __shared__ __align__(8) uint64_t full[kDmStages];
    __shared__ __align__(8) uint64_t empty[kDmStages];
    __shared__ double sq_r[kDmEdge];
    __shared__ double sq_c[kDmEdge];
    __shared__ double v_rows[kClassChunk][kDmEdge];  // V rows of the row tile
    __shared__ double v_cols[kClassChunk][kDmEdge];  // of the column tile
    __shared__ double row_part[2][4][kDmEdge];  // [class parity][warp across]
    __shared__ double col_part[2][2][kDmEdge];  // [class parity][warp down]

    const int tid = threadIdx.x;
    int64_t it, jt;
    grouped_upper_tile(pass.first_block() + blockIdx.x, nt, it, jt);
    const int64_t row0 = it * kDmEdge;
    const int64_t col0 = jt * kDmEdge;
    const bool off_diagonal = jt > it;  // uniform per block
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
        const int64_t r = row0 + tid;
        sq_r[tid] = r < m ? sq[r] : 0.0;
    } else {
        const int64_t c = col0 + tid - kDmEdge;
        sq_c[tid - kDmEdge] = c < m ? sq[c] : 0.0;
    }
    __syncthreads();

    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int wm = warp / 4;  // rows wm * 64 .. + 64 of the tile
    const int wn = warp % 4;  // columns wn * 32 .. + 32
    double acc[4][4][4];
    dmma_tile_product(acc, &xmap, &xmap, row0, col0, nk, ring, ring_ptr, full,
                      empty, tid, wm, wn, g, t);

    dmma_kernel_values<KIND>(acc, sq_r, sq_c, row0, col0, m, m, wm, wn, g, t,
                             degree, gamma, coef0);
    int parity = 0;
    for (int64_t c0 = 0; c0 < C; c0 += kClassChunk) {
        const int cn = static_cast<int>(
            C - c0 < kClassChunk ? C - c0 : kClassChunk);
        __syncthreads();  // the previous chunk's readers are done
        for (int e = tid; e < kDmEdge * cn; e += kDmThreads) {
            const int r = e / cn;
            const int cc = e % cn;
            const int64_t gr = row0 + r;
            const int64_t gc = col0 + r;
            v_rows[cc][r] = gr < m ? V[gr * C + c0 + cc] : 0.0;
            v_cols[cc][r] = gc < m ? V[gc * C + c0 + cc] : 0.0;
        }
        __syncthreads();
        for (int cc = 0; cc < cn; ++cc, parity ^= 1) {
            dmma_row_partials(acc, v_cols[cc], wm, wn, g, t, row_part[parity][wn]);
            if (off_diagonal) {
                dmma_col_partials(acc, v_rows[cc], wm, wn, g, t,
                                  col_part[parity][wm]);
            }
            // the partials of this class are written; the other parity's
            // readers finished before this barrier
            __syncthreads();
            const int64_t c = c0 + cc;
            if (tid < kDmEdge) {
                if (row0 + tid < m) {
                    const double total =
                        (row_part[parity][0][tid] + row_part[parity][1][tid]) +
                        (row_part[parity][2][tid] + row_part[parity][3][tid]);
                    ws[pass.slot(row0 + tid, jt) + c] = total;
                }
            } else if (off_diagonal) {
                const int cl = tid - kDmEdge;
                if (col0 + cl < m) {
                    ws[pass.slot(col0 + cl, it) + c] =
                        col_part[parity][0][cl] + col_part[parity][1][cl];
                }
            }
        }
    }
}

// The partials of out_r[r, c] = sum_j k(xr_r, xc_j) Vc[j, c] and out_c[j,
// c] = sum_r k(xr_r, xc_j) Vr[r, c] over tile (it, jt) of the mr x mc
// block, every tile with the off-diagonal epilogue, into ws_r[(jt ws_rows
// + r) C + c] and ws_c[(it mc + j) C + c] (fixed_sum.cuh run_rows); Xr (a
// band of rows) and Xc arrive through rmap and cmap (mr and mc rows, the
// same feature axis, a multiple of 2), nk boxes of features.
template <int KIND>
__global__ void __launch_bounds__(kDmThreads, 1)
    gram_dmma_dual_kernel(const __grid_constant__ CUtensorMap rmap,
                          const __grid_constant__ CUtensorMap cmap,
                          const double* __restrict__ sq_r,
                          const double* __restrict__ sq_c,
                          const double* __restrict__ Vc,
                          const double* __restrict__ Vr,
                          double* __restrict__ ws_r,
                          double* __restrict__ ws_c, int64_t ws_rows,
                          int64_t mr, int64_t mc, int64_t C, int nk, int n_rt,
                          int n_ct, int degree, double gamma, double coef0) {
    extern __shared__ uint8_t dm_ring[];
    __shared__ __align__(8) uint64_t full[kDmStages];
    __shared__ __align__(8) uint64_t empty[kDmStages];
    __shared__ double sq_rows[kDmEdge];
    __shared__ double sq_cols[kDmEdge];
    __shared__ double v_rows[kClassChunk][kDmEdge];  // Vr rows of the row tile
    __shared__ double v_cols[kClassChunk][kDmEdge];  // Vc rows of the column tile
    __shared__ double row_part[2][4][kDmEdge];  // [class parity][warp across]
    __shared__ double col_part[2][2][kDmEdge];  // [class parity][warp down]

    const int tid = threadIdx.x;
    int64_t it, jt;
    grouped_rect_run(blockIdx.x, n_rt, n_ct, 1, it, jt);
    const int64_t row0 = it * kDmEdge;
    const int64_t col0 = jt * kDmEdge;
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
        const int64_t r = row0 + tid;
        sq_rows[tid] = r < mr ? sq_r[r] : 0.0;
    } else {
        const int64_t c = col0 + tid - kDmEdge;
        sq_cols[tid - kDmEdge] = c < mc ? sq_c[c] : 0.0;
    }
    __syncthreads();

    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int wm = warp / 4;  // rows wm * 64 .. + 64 of the tile
    const int wn = warp % 4;  // columns wn * 32 .. + 32
    double acc[4][4][4];
    dmma_tile_product(acc, &rmap, &cmap, row0, col0, nk, ring, ring_ptr, full,
                      empty, tid, wm, wn, g, t);

    dmma_kernel_values<KIND>(acc, sq_rows, sq_cols, row0, col0, mr, mc, wm, wn,
                             g, t, degree, gamma, coef0);
    int parity = 0;
    for (int64_t c0 = 0; c0 < C; c0 += kClassChunk) {
        const int cn = static_cast<int>(
            C - c0 < kClassChunk ? C - c0 : kClassChunk);
        __syncthreads();  // the previous chunk's readers are done
        for (int e = tid; e < kDmEdge * cn; e += kDmThreads) {
            const int r = e / cn;
            const int cc = e % cn;
            const int64_t gr = row0 + r;
            const int64_t gc = col0 + r;
            v_rows[cc][r] = gr < mr ? Vr[gr * C + c0 + cc] : 0.0;
            v_cols[cc][r] = gc < mc ? Vc[gc * C + c0 + cc] : 0.0;
        }
        __syncthreads();
        for (int cc = 0; cc < cn; ++cc, parity ^= 1) {
            dmma_row_partials(acc, v_cols[cc], wm, wn, g, t, row_part[parity][wn]);
            dmma_col_partials(acc, v_rows[cc], wm, wn, g, t, col_part[parity][wm]);
            // the partials of this class are written; the other parity's
            // readers finished before this barrier
            __syncthreads();
            const int64_t c = c0 + cc;
            if (tid < kDmEdge) {
                if (row0 + tid < mr) {
                    const double total =
                        (row_part[parity][0][tid] + row_part[parity][1][tid]) +
                        (row_part[parity][2][tid] + row_part[parity][3][tid]);
                    ws_r[(jt * ws_rows + row0 + tid) * C + c] = total;
                }
            } else {
                const int cl = tid - kDmEdge;
                if (col0 + cl < mc) {
                    ws_c[(it * mc + col0 + cl) * C + c] =
                        col_part[parity][0][cl] + col_part[parity][1][cl];
                }
            }
        }
    }
}

// The partial of out[r, c] = sum_j k(p_r, s_j) A[j, c] over tile (it, jt)
// of the n_p x n_s rectangle, rows only, into ws[(jt ws_rows + r) C + c]
// (fixed_sum.cuh run_rows); P (a band of rows) and S arrive through pmap and
// smap (n_p and n_s rows, the same feature axis, a multiple of 2), nk boxes
// of features.
template <int KIND>
__global__ void __launch_bounds__(kDmThreads, 1)
    gram_dmma_rect_kernel(const __grid_constant__ CUtensorMap pmap,
                          const __grid_constant__ CUtensorMap smap,
                          const double* __restrict__ sq_p,
                          const double* __restrict__ sq_s,
                          const double* __restrict__ A,
                          double* __restrict__ ws, int64_t ws_rows,
                          int64_t n_p, int64_t n_s, int64_t C, int nk,
                          int n_rt, int n_ct, int degree, double gamma,
                          double coef0) {
    extern __shared__ uint8_t dm_ring[];
    __shared__ __align__(8) uint64_t full[kDmStages];
    __shared__ __align__(8) uint64_t empty[kDmStages];
    __shared__ double sq_rows[kDmEdge];
    __shared__ double sq_cols[kDmEdge];
    __shared__ double a_cols[kClassChunk][kDmEdge];  // A rows of the column tile
    __shared__ double row_part[2][4][kDmEdge];  // [class parity][warp across]

    const int tid = threadIdx.x;
    int64_t it, jt;
    grouped_rect_run(blockIdx.x, n_rt, n_ct, 1, it, jt);
    const int64_t row0 = it * kDmEdge;
    const int64_t col0 = jt * kDmEdge;
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
        const int64_t r = row0 + tid;
        sq_rows[tid] = r < n_p ? sq_p[r] : 0.0;
    } else {
        const int64_t c = col0 + tid - kDmEdge;
        sq_cols[tid - kDmEdge] = c < n_s ? sq_s[c] : 0.0;
    }
    __syncthreads();

    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int wm = warp / 4;  // rows wm * 64 .. + 64 of the tile
    const int wn = warp % 4;  // columns wn * 32 .. + 32
    double acc[4][4][4];
    dmma_tile_product(acc, &pmap, &smap, row0, col0, nk, ring, ring_ptr, full,
                      empty, tid, wm, wn, g, t);

    dmma_kernel_values<KIND>(acc, sq_rows, sq_cols, row0, col0, n_p, n_s, wm,
                             wn, g, t, degree, gamma, coef0);
    int parity = 0;
    for (int64_t c0 = 0; c0 < C; c0 += kClassChunk) {
        const int cn = static_cast<int>(
            C - c0 < kClassChunk ? C - c0 : kClassChunk);
        __syncthreads();  // the previous chunk's readers are done
        for (int e = tid; e < kDmEdge * cn; e += kDmThreads) {
            const int r = e / cn;
            const int cc = e % cn;
            const int64_t gc = col0 + r;
            a_cols[cc][r] = gc < n_s ? A[gc * C + c0 + cc] : 0.0;
        }
        __syncthreads();
        for (int cc = 0; cc < cn; ++cc, parity ^= 1) {
            dmma_row_partials(acc, a_cols[cc], wm, wn, g, t, row_part[parity][wn]);
            // the partials of this class are written; the other parity's
            // readers finished before this barrier
            __syncthreads();
            if (tid < kDmEdge && row0 + tid < n_p) {
                const double total =
                    (row_part[parity][0][tid] + row_part[parity][1][tid]) +
                    (row_part[parity][2][tid] + row_part[parity][3][tid]);
                ws[(jt * ws_rows + row0 + tid) * C + c0 + cc] = total;
            }
        }
    }
}

// Kernels A (C = 1) and C on the DMMA tile: X (m, d_pad) float64, d_pad
// even and X 16-byte aligned (TMA); sq its squared norms; V (m, C) and out
// (m, C) row-major, the sums added to out in the passes of sym_plan.
template <int KIND>
cudaError_t launch_dmma_sym(const double* X, const double* sq, const double* V,
                            double* out, int64_t m, int64_t d_pad, int64_t C,
                            int degree, double gamma, double coef0,
                            const Workspace& workspace, cudaStream_t stream) {
    const int64_t nt = (m + kDmEdge - 1) / kDmEdge;
    const int64_t nk = (d_pad + kDmFeatures - 1) / kDmFeatures;
    if (nt <= 0 || C <= 0 || nk <= 0 || nk > INT32_MAX ||
        !tma_operand_ok<F64Operand>(X, m, d_pad)) {
        return cudaErrorInvalidValue;
    }
    CUtensorMap map;
    auto kernel = gram_dmma_sym_kernel<KIND>;
    if (workspace.base != nullptr) {
        cudaError_t err = encode_operand<F64Operand>(&map, X, m, d_pad);
        if (err == cudaSuccess) {
            err = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDmSmemBytes);
        }
        if (err != cudaSuccess) {
            return err;
        }
    }
    return run_sym<double>(workspace, m, kDmEdge, kTcGroup, C, out, stream,
                           [&](const SymPass& pass, double* ws) {
        kernel<<<static_cast<unsigned int>(pass.blocks()), kDmThreads,
                 kDmSmemBytes, stream>>>(map, sq, V, ws, pass, m, C,
                                         static_cast<int>(nk), nt, degree,
                                         gamma, coef0);
        return cudaGetLastError();
    });
}

// The grid of the dual and rect DMMA tiles over a band of n_r rows R
// against n_c rows S: their tensor maps, nk boxes, n_rt x n_ct blocks.
struct DmGrid {
    CUtensorMap rmap;
    CUtensorMap cmap;
    int nk, n_rt, n_ct;
    unsigned int blocks;
};

inline cudaError_t dmma_grid(const double* R, const double* S, int64_t n_r,
                             int64_t n_c, int64_t d_pad, DmGrid& grid) {
    const int64_t n_rt = (n_r + kDmEdge - 1) / kDmEdge;
    const int64_t n_ct = (n_c + kDmEdge - 1) / kDmEdge;
    const int64_t blocks = n_rt * n_ct;
    const int64_t nk = (d_pad + kDmFeatures - 1) / kDmFeatures;
    if (blocks <= 0 || blocks > INT32_MAX || nk <= 0 || nk > INT32_MAX ||
        !tma_operand_ok<F64Operand>(R, n_r, d_pad) ||
        !tma_operand_ok<F64Operand>(S, n_c, d_pad)) {
        return cudaErrorInvalidValue;
    }
    grid.nk = static_cast<int>(nk);
    grid.n_rt = static_cast<int>(n_rt);
    grid.n_ct = static_cast<int>(n_ct);
    grid.blocks = static_cast<unsigned int>(blocks);
    cudaError_t err = encode_operand<F64Operand>(&grid.rmap, R, n_r, d_pad);
    if (err == cudaSuccess) {
        err = encode_operand<F64Operand>(&grid.cmap, S, n_c, d_pad);
    }
    return err;
}

// Kernels J (C = 1) and K on the dual DMMA tile: Xr (mr, d_pad) and Xc
// (mc, d_pad) float64, d_pad even, both 16-byte aligned (TMA); sq_r, sq_c
// their norms; Vc (mc, C) and Vr (mr, C) row-major; the sums added to
// out_r (mr, C) and out_c (mc, C) in the row bands of run_rows.
template <int KIND>
cudaError_t launch_dmma_dual(const double* Xr, const double* Xc,
                             const double* sq_r, const double* sq_c,
                             const double* Vc, const double* Vr, double* out_r,
                             double* out_c, int64_t mr, int64_t mc,
                             int64_t d_pad, int64_t C, int degree,
                             double gamma, double coef0,
                             const Workspace& workspace, cudaStream_t stream) {
    if (mr <= 0 || mc <= 0 || C <= 0) {
        return cudaErrorInvalidValue;
    }
    auto kernel = gram_dmma_dual_kernel<KIND>;
    if (workspace.base != nullptr) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDmSmemBytes);
        if (err != cudaSuccess) {
            return err;
        }
    }
    const int64_t n_ct = (mc + kDmEdge - 1) / kDmEdge;
    return run_rows<double>(
        workspace, mr, kDmEdge, C, mc, 1, out_r, out_c, stream,
        [&](int64_t) { return n_ct; },
        [&](int64_t row0, int64_t rows, double* ws_r, double* ws_c,
            int64_t ws_rows) {
            DmGrid grid;
            const cudaError_t err = dmma_grid(Xr + row0 * d_pad, Xc, rows, mc,
                                              d_pad, grid);
            if (err != cudaSuccess) {
                return err;
            }
            kernel<<<grid.blocks, kDmThreads, kDmSmemBytes, stream>>>(
                grid.rmap, grid.cmap, sq_r + row0, sq_c, Vc, Vr + row0 * C,
                ws_r, ws_c, ws_rows, rows, mc, C, grid.nk, grid.n_rt,
                grid.n_ct, degree, gamma, coef0);
            return cudaGetLastError();
        });
}

// Kernels B (C = 1) and D on the rect DMMA tile: P (n_p, d_pad) and S
// (n_s, d_pad) float64, d_pad even, both 16-byte aligned (TMA); sq_p, sq_s
// their norms; A (n_s, C) and out (n_p, C) row-major, the sums added to out
// in the row bands of run_rows.
template <int KIND>
cudaError_t launch_dmma_rect(const double* P, const double* S,
                             const double* sq_p, const double* sq_s,
                             const double* A, double* out, int64_t n_p,
                             int64_t n_s, int64_t d_pad, int64_t C, int degree,
                             double gamma, double coef0,
                             const Workspace& workspace, cudaStream_t stream) {
    if (n_p <= 0 || n_s <= 0 || C <= 0) {
        return cudaErrorInvalidValue;
    }
    auto kernel = gram_dmma_rect_kernel<KIND>;
    if (workspace.base != nullptr) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDmSmemBytes);
        if (err != cudaSuccess) {
            return err;
        }
    }
    const int64_t n_ct = (n_s + kDmEdge - 1) / kDmEdge;
    return run_rows<double>(
        workspace, n_p, kDmEdge, C, 0, 1, out, nullptr, stream,
        [&](int64_t) { return n_ct; },
        [&](int64_t row0, int64_t rows, double* ws, double*, int64_t ws_rows) {
            DmGrid grid;
            const cudaError_t err = dmma_grid(P + row0 * d_pad, S, rows, n_s,
                                              d_pad, grid);
            if (err != cudaSuccess) {
                return err;
            }
            kernel<<<grid.blocks, kDmThreads, kDmSmemBytes, stream>>>(
                grid.rmap, grid.cmap, sq_p + row0, sq_s, A, ws, ws_rows, rows,
                n_s, C, grid.nk, grid.n_rt, grid.n_ct, degree, gamma, coef0);
            return cudaGetLastError();
        });
}

// How many blocks of a DMMA tile an SM holds at once (all are designed
// for one), with ``smem`` bytes of dynamic shared memory.
template <typename Kernel>
cudaError_t dmma_blocks_per_sm(Kernel kernel, int smem, int& blocks) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) {
        return err;
    }
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                         kDmThreads, smem);
}

}  // namespace

// Kernel C on the DMMA tile: X (m, d_pad) float64 with an even d_pad,
// 16-byte aligned (ops/gram_matvec.py dmma_operand); sq the norms of X;
// V (m, C) and out (m, C) row-major, out accumulates.  Every entry point
// takes the workspace of fixed_sum.cuh: a null workspace asks for its size,
// written to *workspace_bytes, and launches nothing.
extern "C" int plssvm_gram_matmat_sym_dmma(const double* X, const double* sq,
                                           const double* V, double* out,
                                           int64_t m, int64_t d_pad,
                                           int64_t C, int kind, int degree,
                                           double gamma, double coef0, void* workspace,
    int64_t* workspace_bytes, void* stream) {
    return dmma_dispatch(kind, [&](auto k) {
        return static_cast<int>(launch_dmma_sym<decltype(k)::value>(
            X, sq, V, out, m, d_pad, C, degree, gamma, coef0,
            Workspace{workspace, workspace_bytes},
            static_cast<cudaStream_t>(stream)));
    });
}

// Kernel A: kernel C with one class.
extern "C" int plssvm_gram_matvec_sym_dmma(const double* X, const double* sq,
                                           const double* v, double* out,
                                           int64_t m, int64_t d_pad,
                                           int kind, int degree, double gamma,
                                           double coef0, void* workspace,
    int64_t* workspace_bytes, void* stream) {
    return plssvm_gram_matmat_sym_dmma(X, sq, v, out, m, d_pad, 1, kind,
                                       degree, gamma, coef0,
        workspace, workspace_bytes, stream);
}

// Kernel K on the dual DMMA tile: Xr (mr, d_pad) and Xc (mc, d_pad)
// float64 with an even d_pad, 16-byte aligned; sq_r, sq_c their norms; Vc
// (mc, C), Vr (mr, C), out_r (mr, C) and out_c (mc, C) row-major, the
// outputs accumulate.
extern "C" int plssvm_gram_matmat_dual_dmma(
    const double* Xr, const double* Xc, const double* sq_r, const double* sq_c,
    const double* Vc, const double* Vr, double* out_r, double* out_c,
    int64_t mr, int64_t mc, int64_t d_pad, int64_t C, int kind, int degree,
    double gamma, double coef0, void* workspace,
    int64_t* workspace_bytes, void* stream) {
    return dmma_dispatch(kind, [&](auto k) {
        return static_cast<int>(launch_dmma_dual<decltype(k)::value>(
            Xr, Xc, sq_r, sq_c, Vc, Vr, out_r, out_c, mr, mc, d_pad, C, degree,
            gamma, coef0,
            Workspace{workspace, workspace_bytes},
            static_cast<cudaStream_t>(stream)));
    });
}

// Kernel J: kernel K with one class.
extern "C" int plssvm_gram_matvec_dual_dmma(
    const double* Xr, const double* Xc, const double* sq_r, const double* sq_c,
    const double* v_c, const double* v_r, double* out_r, double* out_c,
    int64_t mr, int64_t mc, int64_t d_pad, int kind, int degree, double gamma,
    double coef0, void* workspace,
    int64_t* workspace_bytes, void* stream) {
    return plssvm_gram_matmat_dual_dmma(Xr, Xc, sq_r, sq_c, v_c, v_r, out_r,
                                        out_c, mr, mc, d_pad, 1, kind, degree,
                                        gamma, coef0,
        workspace, workspace_bytes, stream);
}

// The symmetric DMMA tile's blocks per SM for the kernel function
// ``kind``.
extern "C" int plssvm_gram_dmma_blocks_per_sm(int kind, int* blocks) {
    return dmma_dispatch(kind, [&](auto k) {
        return static_cast<int>(dmma_blocks_per_sm(
            gram_dmma_sym_kernel<decltype(k)::value>, kDmSmemBytes, *blocks));
    });
}

// The dual DMMA tile's blocks per SM for the kernel function ``kind``.
extern "C" int plssvm_gram_dmma_dual_blocks_per_sm(int kind, int* blocks) {
    return dmma_dispatch(kind, [&](auto k) {
        return static_cast<int>(dmma_blocks_per_sm(
            gram_dmma_dual_kernel<decltype(k)::value>, kDmSmemBytes, *blocks));
    });
}

// Kernel D on the rect DMMA tile: P (n_p, d_pad) and S (n_s, d_pad)
// float64 with an even d_pad, 16-byte aligned; sq_p, sq_s their norms; A
// (n_s, C) and out (n_p, C) row-major, out accumulates.
extern "C" int plssvm_gram_matmat_rect_dmma(
    const double* P, const double* S, const double* sq_p, const double* sq_s,
    const double* A, double* out, int64_t n_p, int64_t n_s, int64_t d_pad,
    int64_t C, int kind, int degree, double gamma, double coef0, void* workspace,
    int64_t* workspace_bytes, void* stream) {
    return dmma_dispatch(kind, [&](auto k) {
        return static_cast<int>(launch_dmma_rect<decltype(k)::value>(
            P, S, sq_p, sq_s, A, out, n_p, n_s, d_pad, C, degree, gamma, coef0,
            Workspace{workspace, workspace_bytes},
            static_cast<cudaStream_t>(stream)));
    });
}

// Kernel B: kernel D with one class.
extern "C" int plssvm_gram_matvec_rect_dmma(
    const double* P, const double* S, const double* sq_p, const double* sq_s,
    const double* a, double* out, int64_t n_p, int64_t n_s, int64_t d_pad,
    int kind, int degree, double gamma, double coef0, void* workspace,
    int64_t* workspace_bytes, void* stream) {
    return plssvm_gram_matmat_rect_dmma(P, S, sq_p, sq_s, a, out, n_p, n_s,
                                        d_pad, 1, kind, degree, gamma, coef0,
        workspace, workspace_bytes, stream);
}

// The rect DMMA tile's blocks per SM for the kernel function ``kind``.
extern "C" int plssvm_gram_dmma_rect_blocks_per_sm(int kind, int* blocks) {
    return dmma_dispatch(kind, [&](auto k) {
        return static_cast<int>(dmma_blocks_per_sm(
            gram_dmma_rect_kernel<decltype(k)::value>, kDmSmemBytes, *blocks));
    });
}
