// Fixed-order sums: what the walks of kernels A-M and I add up across
// their blocks, without atomics.
//
// A block of a walk computes partial sums of output entries that other
// blocks add to as well: the row sums of its tile against one column tile
// (or one run of them), and the column sums of its tile against one row
// tile.  Each partial goes to a slot of a workspace that only its block
// writes, once; fixed_sum_kernel then adds the slots of each entry in slot
// order and adds that total to the entry.  The slot of a partial is the
// index of its partner tile (the column tile, or the run, that a row sum
// is taken over; the row tile that a column sum is taken over), so the
// order of every sum is fixed by the shapes and the launch alone: the same
// call twice gives equal bits, as the reference's Pallas kernels do ("no
// atomics, no HBM partials", plssvm_tpu/ops/pallas_matvec.py); an atomic
// sum's order is the order the blocks finish in.  Kernel O (pairs.cu) has
// its own workspace and reduction of the same kind.
//
// The workspace is the wrapper's (ops/gram_matvec.py call_entry, from
// PyTorch's caching allocator): an entry point handed a null workspace
// writes the bytes it needs to *workspace_bytes and launches nothing.  A
// walk whose slots would take more than kWorkspaceBudget runs in passes
// that each fit it, one after another on the stream, each pass's sums
// added to the outputs in pass order:
//
// - a rectangular or dual walk in passes over its row tiles (RowPlan): a
//   pass is the same walk over a band of rows (the operands' pointers, or
//   their tensor maps, start at the band), its row partials in ws_r[q][r]
//   for partner q and band row r, its column partials in ws_c[it][j] for
//   band row tile it and column j;
// - a symmetric walk over the upper triangle in passes over its column
//   tiles [j0, j1) (SymPass): the pass's blocks are a contiguous run of the
//   raster (upper_triangle_tile, and the grouped raster of the tensor-core
//   tiles when j0 is a multiple of kTcGroup), and a row r gets partials
//   from partners j0 .. j1 - 1 (rows above row j0 * edge, the pass's slab)
//   or from partners 0 .. j1 - 1 (rows of the pass's own column tiles, its
//   square: column sums from the tiles above the diagonal, row sums from
//   the diagonal and the tiles right of it).
//
// What bounds the sums: the slots' bytes, written once by the walk and read
// once here, at the card's memory rate; at MNIST's width kernel C's 469
// column tiles x 60000 rows x 10 classes in float32 are 1.1 GB each way,
// about 0.7 ms at 3.35 TB/s beside the product's 16 ms (PERF.md).

#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <vector>

// The launches of fixed_sum_kernel since the library was loaded or the
// count was reset (plssvm_fixed_sum_launches); one counter for the whole
// library, defined in gram_matvec.cu.
std::atomic<int64_t>& fixed_sum_launch_count();

namespace {

// The most bytes the slots of one pass of a walk may take.  A pass is at
// least one step of tiles, so a walk of very many rows may need more.
constexpr int64_t kWorkspaceBudget = int64_t(512) << 20;
constexpr int kSumThreads = 256;

// out[e] += ws[e] + ws[stride + e] + ... + ws[(slots - 1) stride + e] for
// e < n, the slots added in order from 0.
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
    fixed_sum_kernel(const T* __restrict__ ws, int64_t slots, int64_t stride,
                     int64_t n, T* __restrict__ out) {
    const int64_t e = int64_t(blockIdx.x) * kSumThreads + threadIdx.x;
    if (e >= n) {
        return;
    }
    const T* p = ws + e;
    T total = T(0);
#pragma unroll 4
    for (int64_t s = 0; s < slots; ++s) {
        total += p[s * stride];
    }
    out[e] += total;
}

template <typename T>
cudaError_t fixed_sum(const T* ws, int64_t slots, int64_t stride, int64_t n,
                      T* out, cudaStream_t stream) {
    if (n <= 0 || slots <= 0) {
        return cudaSuccess;
    }
    const int64_t blocks = (n + kSumThreads - 1) / kSumThreads;
    if (blocks > INT32_MAX) {
        return cudaErrorInvalidValue;
    }
    fixed_sum_kernel<T><<<static_cast<unsigned int>(blocks), kSumThreads, 0,
                          stream>>>(ws, slots, stride, n, out);
    fixed_sum_launch_count().fetch_add(1);
    return cudaGetLastError();
}

// The workspace an entry point is handed: a null base asks for its size.
struct Workspace {
    void* base;
    int64_t* bytes;
};

// Whether the launcher goes on to launch with a workspace of ``need``
// bytes: in a size query it writes need to *bytes and returns false with
// err cudaSuccess; a workspace smaller than need gives false and
// cudaErrorInvalidValue.
inline bool take_workspace(const Workspace& ws, int64_t need, cudaError_t& err) {
    err = cudaSuccess;
    if (ws.bytes == nullptr || need < 0) {
        err = cudaErrorInvalidValue;
        return false;
    }
    if (ws.base == nullptr) {
        *ws.bytes = need;
        return false;
    }
    if (*ws.bytes < need) {
        err = cudaErrorInvalidValue;
        return false;
    }
    return true;
}

// One pass of a symmetric walk over nt tiles of ``edge`` rows: the blocks
// of column tiles [j0, j1), the upper triangle's blocks first_block() ..
// first_block() + blocks() - 1 of the raster.  slot(r, p) is the offset of
// class 0 of row r's partial from partner tile p (C classes a row): the
// slab of rows [0, j0 edge) takes partners j0 .. j1 - 1, the square of
// rows [j0 edge, j1 edge) partners 0 .. j1 - 1.
struct SymPass {
    int64_t j0;
    int64_t j1;
    int64_t edge;
    int64_t C;

    __host__ __device__ int64_t split() const { return j0 * edge; }
    __host__ __device__ int64_t width() const { return (j1 - j0) * edge; }
    __host__ __device__ int64_t slab_values() const { return (j1 - j0) * split() * C; }
    __host__ __device__ int64_t values() const { return slab_values() + j1 * width() * C; }
    __host__ __device__ int64_t first_block() const { return j0 * (j0 + 1) / 2; }
    __host__ __device__ int64_t blocks() const { return j1 * (j1 + 1) / 2 - first_block(); }
    __host__ __device__ int64_t slot(int64_t r, int64_t p) const {
        return r < split() ? ((p - j0) * split() + r) * C
                           : slab_values() + (p * width() + r - split()) * C;
    }
};

// The passes of a symmetric walk over m rows in tiles of ``edge``, each
// the widest run of column tiles, in steps of ``step`` tiles, whose slots
// of ``item`` bytes fit kWorkspaceBudget (at least one step).
inline std::vector<SymPass> sym_plan(int64_t m, int64_t edge, int64_t step,
                                     int64_t C, int64_t item) {
    std::vector<SymPass> passes;
    const int64_t nt = (m + edge - 1) / edge;
    const int64_t budget = kWorkspaceBudget / item;
    int64_t j0 = 0;
    while (j0 < nt) {
        int64_t j1 = std::min(nt, j0 + step);
        while (j1 < nt) {
            const int64_t next = std::min(nt, j1 + step);
            if (SymPass{j0, next, edge, C}.values() > budget) {
                break;
            }
            j1 = next;
        }
        passes.push_back(SymPass{j0, j1, edge, C});
        j0 = j1;
    }
    return passes;
}

inline int64_t sym_plan_bytes(const std::vector<SymPass>& passes, int64_t item) {
    int64_t most = 0;
    for (const SymPass& p : passes) {
        most = std::max(most, p.values() * item);
    }
    return most;
}

// Adds a pass's slots to out (m rows of C classes): the slab's rows, then
// the square's.
template <typename T>
cudaError_t sym_pass_sums(const T* ws, const SymPass& p, int64_t m, T* out,
                          cudaStream_t stream) {
    cudaError_t err = fixed_sum(ws, p.j1 - p.j0, p.split() * p.C,
                                std::min(p.split(), m) * p.C, out, stream);
    if (err != cudaSuccess) {
        return err;
    }
    const int64_t rows = std::min(p.split() + p.width(), m) - p.split();
    return fixed_sum(ws + p.slab_values(), p.j1, p.width() * p.C, rows * p.C,
                     out + p.split() * p.C, stream);
}

// The row bands of a rectangular or dual walk over n rows: bands of
// ``tiles`` row tiles of ``edge`` rows each (the last may hold fewer),
// the most whose workspace, values(rows) values of ``item`` bytes for a
// band of ``rows`` rows, fits kWorkspaceBudget (at least one tile).
struct RowPlan {
    int64_t tiles;  // row tiles a band
    int64_t edge;
    int64_t n;
    int64_t bytes;  // the largest band's workspace

    int64_t bands() const { return (n + tiles * edge - 1) / (tiles * edge); }
    int64_t row0(int64_t band) const { return band * tiles * edge; }
    int64_t rows(int64_t band) const { return std::min(n - row0(band), tiles * edge); }
};

// values(rows) must not shrink as rows grow.
template <typename Values>
RowPlan row_plan(int64_t n, int64_t edge, int64_t item, const Values& values) {
    const int64_t nt = (n + edge - 1) / edge;
    const int64_t budget = kWorkspaceBudget / item;
    int64_t lo = 1;  // fits, or is the least band
    int64_t hi = nt;
    while (lo < hi) {
        const int64_t mid = (lo + hi + 1) / 2;
        if (values(std::min(n, mid * edge)) <= budget) {
            lo = mid;
        } else {
            hi = mid - 1;
        }
    }
    RowPlan plan{lo, edge, n, 0};
    for (int64_t b = 0; b < plan.bands(); ++b) {
        plan.bytes = std::max(plan.bytes, values(plan.rows(b)) * item);
    }
    return plan;
}

// A symmetric walk over m rows in tiles of ``edge`` in the passes of
// sym_plan: launch(pass, ws) launches the pass's blocks, which write their
// partials into ws (values of T), and the pass's sums are added to out (m
// rows of C classes) before the next pass.
template <typename T, typename Launch>
cudaError_t run_sym(const Workspace& workspace, int64_t m, int64_t edge,
                    int64_t step, int64_t C, T* out, cudaStream_t stream,
                    const Launch& launch) {
    const std::vector<SymPass> passes = sym_plan(m, edge, step, C, sizeof(T));
    cudaError_t err;
    if (!take_workspace(workspace, sym_plan_bytes(passes, sizeof(T)), err)) {
        return err;
    }
    T* ws = static_cast<T*>(workspace.base);
    for (const SymPass& p : passes) {
        if (p.blocks() <= 0 || p.blocks() > INT32_MAX) {
            return cudaErrorInvalidValue;
        }
        err = launch(p, ws);
        if (err == cudaSuccess) {
            err = sym_pass_sums(ws, p, m, out, stream);
        }
        if (err != cudaSuccess) {
            return err;
        }
    }
    return cudaSuccess;
}

// A rectangular (n_cols 0) or dual walk over n rows in tiles of ``edge``,
// in the row bands of row_plan: a band of ``rows`` rows has
// row_slots(rows) partners for each row (its column tiles, or runs of
// them) and, when dual, col_parts slots for each of its ceil(rows / edge)
// row tiles as the partners of each of the n_cols columns.
// launch(row0, rows, ws_r, ws_c, ws_rows) launches the walk over rows
// [row0, row0 + rows), whose row partials go to ws_r[(q ws_rows + r) C + c]
// for band row r and partner q, its column partials to ws_c[((it col_parts
// + h) n_cols + j) C + c] for band row tile it and part h; the band's sums
// are added to out_r (n rows) and out_c (n_cols rows of C classes) before
// the next band.
template <typename T, typename RowSlots, typename Launch>
cudaError_t run_rows(const Workspace& workspace, int64_t n, int64_t edge,
                     int64_t C, int64_t n_cols, int64_t col_parts, T* out_r,
                     T* out_c, cudaStream_t stream, const RowSlots& row_slots,
                     const Launch& launch) {
    const auto tiles = [edge](int64_t rows) { return (rows + edge - 1) / edge; };
    const auto row_values = [&](int64_t rows) {
        return row_slots(rows) * tiles(rows) * edge * C;
    };
    const RowPlan plan = row_plan(n, edge, sizeof(T), [&](int64_t rows) {
        return row_values(rows) + tiles(rows) * col_parts * n_cols * C;
    });
    cudaError_t err;
    if (!take_workspace(workspace, plan.bytes, err)) {
        return err;
    }
    T* ws_r = static_cast<T*>(workspace.base);
    for (int64_t b = 0; b < plan.bands(); ++b) {
        const int64_t row0 = plan.row0(b);
        const int64_t rows = plan.rows(b);
        const int64_t ws_rows = tiles(rows) * edge;
        T* ws_c = ws_r + row_values(rows);
        err = launch(row0, rows, ws_r, ws_c, ws_rows);
        if (err == cudaSuccess) {
            err = fixed_sum(ws_r, row_slots(rows), ws_rows * C, rows * C,
                            out_r + row0 * C, stream);
        }
        if (err == cudaSuccess && n_cols > 0) {
            err = fixed_sum(ws_c, tiles(rows) * col_parts, n_cols * C,
                            n_cols * C, out_c, stream);
        }
        if (err != cudaSuccess) {
            return err;
        }
    }
    return cudaSuccess;
}

}  // namespace
