"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each or more (the run stops at the first that fails):

1. device: the card, its power limit, the CUDA toolkit;
2. build: nvcc compiles plssvm_tpu_torch/csrc into plssvm_tpu_torch/_build,
   one process per source, and reports each kernel's registers, spills and
   shared memory;
3. kernels: kernel A (gram_matvec_sym), kernel B (gram_matvec_rect),
   kernel C (gram_matmat_sym) and kernel D (gram_matmat_rect) against their
   plain PyTorch versions on the card, poly / RBF / sigmoid in float32 and
   float64, ragged and multi-tile shapes, 1 to 37 classes, and the main
   paths' own shapes; then all four timed against their plain versions;
4. end to end, BASELINE config 2: RBF on a seeded two-class 10000 x 200
   set, trained with plssvm-torch-train and scored with plssvm-torch-predict
   on 2000 held-out points; the kernels' launch counts prove the path went
   through them; a float64 fit must agree with the float32 one; a small
   float64 fit must agree between the kernels and the plain versions;
5. multiclass end to end: the same shape with 10 classes, one-vs-all,
   through both CLIs; kernels C and D's launch counts, accuracy against a
   floor, float32/float64 agreement, and a small float64 fit through the
   kernels against the plain versions;
6. the width of BASELINE config 3: polynomial on 50000 x 500 scaled to
   [-1, 1], 20 CG iterations;
7. multiclass at the width and class count of MNIST: 60000 x 784, 10
   classes, fitted and scored through CSVM in memory;
8. laplacian, binary: phase 4's config 2 files through both CLIs with
   ``-t 4``, CG through kernel E and predict through kernel F; accuracy
   floor, float32/float64 agreement, and a small float64 fit through the
   kernels against the plain versions;
9. chi-squared, 10 classes: seeded histogram classes (L1-normalised word
   counts) at config 2's shape through both CLIs with ``-t 5``, block CG
   through kernel G and predict through kernel H; accuracy floor under the
   Bayes-optimal rule, float32/float64 agreement;
10. chi-squared at MNIST width: the same histogram classes, 60000 x 784,
   fitted and scored through CSVM in memory with max_iter capped from
   kernel G's measured time;
11. the banded tool: ``python -m plssvm_tpu_torch.tools.exp_banded_distance``
   at its defaults (32768 x 128, 4 normalised products through kernel I)
   and with ``--check``;
12. the matvec bench: ``python -m plssvm_tpu_torch.tools.bench_matvec`` at
   8192 x 256 with 64 products per timing, for RBF (``kernel_matvec``, K6's
   port over kernel A, and kernel B beside the plain version) and
   laplacian (kernel E beside the plain version).

Phases 8 and 9 run right after phase 5, while the files of phases 4 and 5
exist; phase 10 runs after phase 7, then phases 11 and 12.

Phase 3 also holds kernels E-H (laplacian / chi-squared matvecs and block
matmats, csrc/distance.cu) against their plain versions on ragged shapes
with non-negative, zero-rich data and at phases 8-10's shapes, and times
them there and, beside kernel A, at m = 16384, d = 256; kernel I (the
banded laplacian matvec, csrc/banded.cu) against its plain version and
kernel E on ragged shapes and at phase 11's shape, where it is timed
beside kernel E; and ``kernel_matvec`` against kernel A and its plain
version, timed at kernel A's shape.  Beside every kernel's time it
computes the bound: the least time the card could take for the function
on these inputs (see ``_bound``), and fails if a kernel measures faster
than that (a wrong bound or a wrong timing).  At phases 9 and 10's shapes
it holds kernels E-H in float32 chi-squared per entry of K against the
plain version in float64 (one-hot right-hand sides pick columns of K) and
logs each one's error beside the float32 plain version's and its share of
the bound.

Before the last line it prints the card's name and power limit as
nvidia-smi reports them, and one JSON object describing each of the ten
kernels; the last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the repository around it, the script fails and prints no result.
"""

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

#: accuracy floor on the 2000 held-out points of phase 4.  The set's two
#: Gaussian classes overlap (means +-0.1 per feature, unit variance), so the
#: Bayes-optimal accuracy is about 0.92; a float64 run of the plain
#: versions on a CPU scores 0.9125.
ACCURACY_FLOOR = 0.89
#: accuracy floor of phases 5 and 7.  Their classes are isotropic unit
#: Gaussians around seeded means whose pairwise distances average
#: MC_SEPARATION; for such classes the Bayes-optimal rule is the nearest
#: mean, which numpy scores by Monte Carlo at 0.870 (200 features) and 0.873
#: (784 features) over 20000 draws.  A float32 run of the plain versions on
#: a CPU scores 0.8535 on phase 5's held-out points.
MC_ACCURACY_FLOOR = 0.83
MC_SEPARATION = 4.0
MC_CLASSES = 10
#: phase 4 trains to epsilon 1e-8: from the reference's start vector x = 1
#: the first CG step alone cuts the residual of this 10000-point system by
#: more than 1e-3 squared, so epsilon 1e-3 stops after one iteration at a
#: model no better than chance (plssvm_tpu does the same).
EPSILON = 1e-8
#: accuracy floor of phase 8 (laplacian on config 2's files; Bayes-optimal
#: about 0.92).  A float64 run of the plain versions scores 0.9230, on the
#: card: at 10000 x 200 the plain laplacian takes minutes per CG iteration
#: on a CPU.
LAPLACIAN_ACCURACY_FLOOR = 0.89
#: accuracy floor of phases 9 and 10 (chi-squared on the histogram
#: classes).  The Bayes-optimal rule scores 0.895 (phase 9's 200 bins) and
#: 0.922 (phase 10's 784 bins) by Monte Carlo; on phase 9's set a float64
#: fit on the card scores 0.8660 at CHI2_EPSILON (0.8665 in float32).
CHI2_ACCURACY_FLOOR = 0.84
#: phases 9 and 10 train to epsilon 1e-7, not 1e-8: on the histogram
#: classes float32 CG does not reach 1e-8 (one class ran 4343 block
#: iterations and its decision values swamped the argmax), while at 1e-7
#: it stops after 37 iterations and its labels agree with float64's on
#: 0.999 (0.994 at 1e-6)
CHI2_EPSILON = 1e-7
F32_TOL, F64_TOL = 1e-4, 1e-10
SEED = 20261016
#: the histogram classes of phases 9 and 10: a base bin distribution drawn
#: from Dirichlet(HIST_ALPHA), each class's from Dirichlet(HIST_CONC * d *
#: base), so the classes overlap; a point is HIST_WORDS words drawn from its
#: class's distribution, divided by HIST_WORDS.  About 80 % (200 bins) and
#: 93 % (784 bins) of the features are 0.
HIST_ALPHA, HIST_CONC, HIST_WORDS = 0.5, 5.0, 60
#: the kernels phase times the plain distance versions over this many
#: launches on each side of the kernel, after one warm-up: one launch takes
#: 0.55 s (laplacian) to 2 s (chi-squared) at m = 16384, d = 256
DIST_PLAIN_REPEATS = 3
#: seconds of kernel-G work phase 10 may spend in CG (max_iter is derived
#: from kernel G's time measured at its shape in the kernels phase)
CHI_WIDTH_CG_SECONDS = 50.0
#: phase 10 trains to epsilon 1e-6: it has no float64 comparison, and at
#: 1e-6 CG reaches epsilon within the time above (26 iterations of ~1.5 s
#: on an H100), where 1e-7 would need ~38
CHI_WIDTH_EPSILON = 1e-6
#: the matvec bench's shape and products per timing (phase 12)
BENCH_M, BENCH_D, BENCH_ITERS = 8192, 256, 64
#: the banded tool's default shape and products per timing (phase 11)
BANDED_M, BANDED_D, BANDED_ITERS = 32768, 128, 4

#: NVIDIA's published H100 SXM peaks (data sheet, dense, at the 700 W
#: limit): 67 TFLOP/s in float32 outside the tensor cores, which is 33.5 T
#: FP32 instructions/s (an FFMA counts two flops); the special-function
#: units return 16 results per SM and clock against 128 FP32 lanes, 1/8 of
#: that; 3.35 TB/s of HBM3; 495 TFLOP/s TF32 on the tensor cores (logged
#: beside the Gram kernels' bounds only, for ROADMAP Queue 4)
FP32_INSTR_PER_S = 67e12 / 2
SFU_OPS_PER_S = FP32_INSTR_PER_S / 8
HBM_BYTES_PER_S = 3.35e12
TF32_FLOP_PER_S = 495e12
#: the fewest (FP32 instructions, SFU operations) per pair and feature: a
#: Gram product one FFMA; a laplacian term a subtract and an add with |.|;
#: a chi-squared term (x - y)^2 / (x + y) a subtract, an add, a multiply
#: and the multiply by the reciprocal on the FP32 lanes, the reciprocal on
#: the SFU
PAIR_FEATURE_COST = {"gram": (1, 0), "laplacian": (2, 0), "chi_squared": (4, 1)}


def log(phase, message):
    print(f"[{phase}] {message}", flush=True)


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME or "", "bin", "nvcc")
    nvcc_version = subprocess.run(
        [nvcc, "--version"], capture_output=True, text=True, check=True,
        timeout=60,
    ).stdout.strip().splitlines()[-1]
    log("device", f"{name} | {smi} | torch {torch.__version__} CUDA "
        f"{torch.version.cuda} | nvcc {nvcc_version}")
    return name, smi


def phase_build():
    from plssvm_tpu_torch.ops import _build

    path, seconds = _build.build()
    _build.load()
    log("build", f"{path.name} in {seconds:.2f} s"
        + (" (nvcc ran, one process per source)" if seconds > 0
           else " (already built)"))
    for name, res in sorted(_build.kernel_resources().items()):
        log("build", f"{name}: {res.get('registers')} registers, "
            f"{res.get('spill_bytes')} spill bytes, "
            f"{res.get('smem_bytes')} B static shared memory")


def _operands(m, d, dtype, gen, n_points=None, n_classes=None):
    """Seeded unit-normal rows on the card: X (m, d), points P, and v (m,)
    or, with n_classes, V (m, n_classes)."""
    dev = torch.device("cuda")
    X = torch.randn(m, d, generator=gen, dtype=torch.float64).to(dev, dtype)
    P = torch.randn(n_points or m // 2 + 1, d, generator=gen,
                    dtype=torch.float64).to(dev, dtype)
    shape = (m,) if n_classes is None else (m, n_classes)
    v = torch.randn(*shape, generator=gen, dtype=torch.float64).to(dev, dtype)
    return X, P, v


def _pairs(v):
    """(name, kernel, plain) of the symmetric and the rectangular kernel for
    a right-hand side v (m,) (kernels A, B) or V (m, C) (kernels C, D)."""
    from plssvm_tpu_torch.ops import gram_matmat, gram_matvec, matvec

    if v.ndim == 2:
        return (
            ("gram_matmat_sym", gram_matmat.gram_matmat_sym,
             matvec.kernel_matmat_plain),
            ("gram_matmat_rect", gram_matmat.gram_matmat_rect,
             matvec.kernel_matmat_rect_plain),
        )
    return (
        ("gram_matvec_sym", gram_matvec.gram_matvec_sym,
         matvec.kernel_matvec_plain),
        ("gram_matvec_rect", gram_matvec.gram_matvec_rect,
         matvec.kernel_matvec_rect_plain),
    )


def _check_close(label, got, want):
    """(max|got - want|, max|want|); raise past the tolerance of the type."""
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    tol = F32_TOL if got.dtype == torch.float32 else F64_TOL
    if not (got.shape == want.shape and torch.isfinite(got).all()
            and err <= tol * scale):
        raise AssertionError(f"{label}: max|err| {err} vs max|plain| {scale}")
    return err, scale


def _compare(kind, coef0, X, P, v):
    """max|kernel - plain| and max|plain| for kernels A and B (v (m,)) or
    C and D (v (m, C))."""
    kw = dict(kind=kind, gamma=1.0 / X.shape[1], coef0=coef0, degree=3)
    sq, sq_p = (X * X).sum(-1), (P * P).sum(-1)
    (sym_name, sym, sym_plain), (rect_name, rect, rect_plain) = _pairs(v)
    out = {}
    for name, kernel, plain, args in (
        (sym_name, sym, sym_plain, (X, sq, v)),
        (rect_name, rect, rect_plain, (P, X, sq_p, sq, v)),
    ):
        out[name] = _check_close(
            f"{name} {kind} {X.dtype} {tuple(X.shape)}",
            kernel(*args, **kw), plain(*args, **kw),
        )
    return out


def _distance_pairs(v):
    """(name, kernel, plain) of the symmetric and the rectangular distance
    kernel for v (m,) (kernels E, F) or V (m, C) (kernels G, H)."""
    from plssvm_tpu_torch.ops import distance, matvec

    if v.ndim == 2:
        return (
            ("distance_matmat_sym", distance.distance_matmat_sym,
             matvec.distance_matmat_plain),
            ("distance_matmat_rect", distance.distance_matmat_rect,
             matvec.distance_matmat_rect_plain),
        )
    return (
        ("distance_matvec_sym", distance.distance_matvec_sym,
         matvec.distance_matvec_plain),
        ("distance_matvec_rect", distance.distance_matvec_rect,
         matvec.distance_matvec_rect_plain),
    )


def _compare_distance(kind, X, P, v, gamma):
    """max|kernel - plain| and max|plain| for kernels E and F (v (m,)) or
    G and H (v (m, C)), P the points against the rows of X."""
    kw = dict(kind=kind, gamma=gamma)
    (sym_name, sym, sym_plain), (rect_name, rect, rect_plain) = _distance_pairs(v)
    return {
        name: _check_close(f"{name} {kind} {X.dtype} {tuple(X.shape)}",
                           kernel(*args, **kw), plain(*args, **kw))
        for name, kernel, plain, args in (
            (sym_name, sym, sym_plain, (X, v)),
            (rect_name, rect, rect_plain, (P, X, v)),
        )
    }


def _histogram_classes(rng, d, n_classes=MC_CLASSES):
    """(n_classes, d) bin distributions around one base distribution."""
    base = rng.dirichlet(np.full(d, HIST_ALPHA))
    return np.stack([rng.dirichlet(HIST_CONC * d * base)
                     for _ in range(n_classes)])


def _draw_histograms(rng, probs, n):
    """n L1-normalised histograms of HIST_WORDS words from the classes
    ``probs``: (features, labels, word counts)."""
    labels = rng.integers(0, len(probs), n)
    counts = rng.multinomial(HIST_WORDS, probs[labels])
    return counts / HIST_WORDS, labels, counts


def _bayes_accuracy(rng, probs, n=20000):
    """Monte-Carlo accuracy of the Bayes-optimal rule for the multinomial
    classes: argmax_c sum_k counts_k log p_ck (equal priors)."""
    _, labels, counts = _draw_histograms(rng, probs, n)
    log_p = np.log(np.maximum(probs, 1e-300))
    return float(np.mean(np.argmax(counts @ log_p.T, axis=1) == labels))


def _chi2_gamma(rng, X, pairs=2000):
    """1 / the mean chi-squared distance over seeded pairs of rows (Zhang,
    Marszalek, Lazebnik & Schmid, IJCV 2007)."""
    i = rng.integers(0, len(X), pairs)
    j = (i + 1 + rng.integers(0, len(X) - 1, pairs)) % len(X)  # j != i
    num = (X[i] - X[j]) ** 2
    den = X[i] + X[j]
    dist = np.sum(np.divide(num, den, out=np.zeros_like(num), where=den > 0),
                  axis=1)
    return float(1.0 / dist.mean())


def _zero_rich(m, d, dtype, gen):
    """Non-negative rows on the card, about a third of the entries 0 and
    one row all 0, so chi-squared's 0/0 rule is on the path."""
    X = torch.rand(m, d, generator=gen, dtype=torch.float64)
    X[X < 0.33] = 0.0
    X[m // 2] = 0.0
    return X.to("cuda", dtype)


def _distance_kernels(gen, main_err, main_ms, timing, bounds, time_a):
    """Kernels E-H against their plain versions, then timed at the main
    paths' shapes (into main_ms) and at m = 16384, d = 256; fills main_err
    / timing / bounds under (name, kind) and returns kernel G's
    chi-squared ms at phase 10's shape (59999 x 784, 10 classes)."""
    from plssvm_tpu_torch.parameter import KernelFunctionType as K

    kinds = (K.LAPLACIAN, K.CHI_SQUARED)
    worst = {}
    for dtype in (torch.float32, torch.float64):
        for m, d in ((1037, 203), (300, 1280), (129, 3), (1, 1)):
            for n_classes in (None, 1, 3, 10, 37):
                X, P = _zero_rich(m, d, dtype, gen), _zero_rich(m // 2 + 1, d, dtype, gen)
                shape = (m,) if n_classes is None else (m, n_classes)
                v = torch.randn(*shape, generator=gen, dtype=torch.float64).to("cuda", dtype)
                for kind in kinds:
                    for name, (err, scale) in _compare_distance(kind, X, P, v, 1.0 / d).items():
                        key = (name, str(dtype).split(".")[-1])
                        worst[key] = max(worst.get(key, 0.0), err / max(scale, 1e-300))
    for (name, dt), rel in sorted(worst.items()):
        log("kernels", f"{name} {dt}: worst max|err|/max|plain| {rel:.3e} over "
            "laplacian/chi-squared x 4 shapes" + (" x 1-37 classes" if "matmat" in name else ""))

    # the main paths' shapes, f32: phase 8 (laplacian, config 2: 9999 x 200
    # training, 2000 points against 10000 SVs), phase 9 (chi-squared, 10
    # classes, the same shape) and phase 10 (chi-squared, 59999 x 784
    # training, 10000 points against 60000 SVs: the plain versions check
    # the first 512 output rows, the whole square would take minutes)
    from plssvm_tpu_torch.ops import distance, matvec

    def time_main(name, kernel, plain, args, kw, label, phase):
        """The kernel and, unless ``plain`` is None, its plain version at
        the shape ``phase`` gives it; records the kernel's ms beside its
        bound in main_ms and returns the ms."""
        rows, d_ = args[0].shape
        cols = args[1].shape[0] if len(args) == 3 else rows
        work = float(rows) * cols * d_
        columns = args[-1].shape[1] if args[-1].ndim == 2 else 1
        bound = (_rect_bound(rows, cols, d_, columns, str(kw["kind"]), 4)
                 if len(args) == 3 else
                 _sym_bound(rows, d_, columns, str(kw["kind"]), 4))
        if plain is None:
            k_ms = _median_ms(lambda: kernel(*args, **kw), DIST_PLAIN_REPEATS, 1)
            log("kernels", f"{name} {label}: kernel {k_ms:.3f} ms (median of "
                f"{DIST_PLAIN_REPEATS} after 1 warm-up; the plain version takes "
                "minutes here)")
        else:
            k_ms = _time_pair(name, kernel, plain, args, kw, work, label,
                              plain_repeats=DIST_PLAIN_REPEATS, unit="Tpair-feature/s",
                              counted="rows x columns x d")[0]
        main_ms[(name, phase)] = (k_ms, bound[0])
        _log_bound(name, label, k_ms, bound)
        return k_ms

    rng = np.random.default_rng(SEED + 10)
    S, P, a = _operands(10000, 200, torch.float32, gen, n_points=2000)
    X, v = S[:9999].contiguous(), a[:9999].contiguous()
    kw = dict(kind=K.LAPLACIAN, gamma=1.0 / 200)
    (sym_name, sym, sym_plain), (rect_name, rect, rect_plain) = _distance_pairs(v)
    sym_err = _check_close("distance_matvec_sym laplacian 9999x200",
                           sym(X, v, **kw), sym_plain(X, v, **kw))
    rect_err = _check_close("distance_matvec_rect laplacian 2000x10000x200",
                            rect(P, S, a, **kw), rect_plain(P, S, a, **kw))
    main_err[(sym_name, "laplacian")] = sym_err[0]
    main_err[(rect_name, "laplacian")] = rect_err[0]
    log("kernels", f"main-path shapes f32 laplacian: sym 9999x200 max|err| "
        f"{sym_err[0]:.3e} (max|plain| {sym_err[1]:.3e}), rect 2000x10000x200 "
        f"{rect_err[0]:.3e} (max|plain| {rect_err[1]:.3e})")
    time_main(sym_name, sym, sym_plain, (X, v), kw, "9999x200 f32 laplacian",
              "laplacian")
    time_main(rect_name, rect, rect_plain, (P, S, a), kw,
              "2000x10000x200 f32 laplacian", "laplacian")
    g_ms = {}
    for m, d, n_points in ((10000, 200, 2000), (60000, 784, 10000)):
        probs = _histogram_classes(rng, d)
        Xn = _draw_histograms(rng, probs, m)[0]
        gamma = _chi2_gamma(rng, Xn)
        S = torch.as_tensor(Xn, dtype=torch.float32, device="cuda")
        X = S[:m - 1].contiguous()
        P = torch.as_tensor(_draw_histograms(rng, probs, n_points)[0],
                            dtype=torch.float32, device="cuda")
        A = torch.randn(m, MC_CLASSES, generator=gen, dtype=torch.float64).to("cuda", torch.float32)
        V = A[:m - 1].contiguous()
        kw = dict(kind=K.CHI_SQUARED, gamma=gamma)
        rows = 512 if m > 10000 else m - 1
        sym = _check_close(f"distance_matmat_sym chi2 {m - 1}x{d}",
                           distance.distance_matmat_sym(X, V, **kw)[:rows],
                           matvec.distance_matmat_rect_plain(X[:rows], X, V, **kw))
        rows = 512 if m > 10000 else n_points
        rect = _check_close(f"distance_matmat_rect chi2 {n_points}x{m}x{d}",
                            distance.distance_matmat_rect(P, S, A, **kw)[:rows],
                            matvec.distance_matmat_rect_plain(P[:rows], S, A, **kw))
        for name, (err, _) in (("distance_matmat_sym", sym), ("distance_matmat_rect", rect)):
            key = (name, "chi_squared")
            main_err[key] = max(main_err.get(key, 0.0), err)
        log("kernels", f"main-path shapes f32 chi-squared, {MC_CLASSES} classes, "
            f"gamma {gamma:.4f}: sym {m - 1}x{d} max|err| {sym[0]:.3e} (max|plain| "
            f"{sym[1]:.3e}), rect {n_points}x{m}x{d} {rect[0]:.3e} (max|plain| "
            f"{rect[1]:.3e})" + (" (first 512 rows)" if m > 10000 else ""))
        full = m <= 10000  # the plain versions only where they take seconds
        phase = "chi2-cli" if full else "chi2-width"
        g_ms[m] = time_main(
            "distance_matmat_sym", distance.distance_matmat_sym,
            matvec.distance_matmat_plain if full else None, (X, V), kw,
            f"{m - 1}x{d} f32 chi_squared C={MC_CLASSES}", phase)
        time_main("distance_matmat_rect", distance.distance_matmat_rect,
                  matvec.distance_matmat_rect_plain if full else None, (P, S, A),
                  kw, f"{n_points}x{m}x{d} f32 chi_squared C={MC_CLASSES}", phase)
        _chi2_per_entry(main_ms, phase, X, S, P, gamma)

    # timing at m = 16384, d = 256, f32, on histogram rows, C = 10 for G
    # and H; the plain versions over DIST_PLAIN_REPEATS launches
    m, d = 16384, 256
    X = torch.as_tensor(_draw_histograms(rng, _histogram_classes(rng, d), m)[0],
                        dtype=torch.float32, device="cuda")
    v = torch.randn(m, generator=gen, dtype=torch.float64).to("cuda", torch.float32)
    V = torch.randn(m, MC_CLASSES, generator=gen, dtype=torch.float64).to("cuda", torch.float32)
    a_ms = time_a(X)
    for kind in kinds:
        kw = dict(kind=kind, gamma=1.0 / d)
        for rhs in (v, V):
            label = f"m={m} d={d} f32 {kind}" + (f" C={rhs.shape[1]}" if rhs.ndim == 2 else "")
            for name, kernel, plain in _distance_pairs(rhs):
                args = (X, rhs) if "sym" in name else (X, X, rhs)
                timing[(name, str(kind))] = _time_pair(
                    name, kernel, plain, args, kw, float(m) * m * d, label,
                    plain_repeats=DIST_PLAIN_REPEATS, unit="Tpair-feature/s",
                    counted="m^2 d")
                columns = 1 if rhs.ndim == 1 else rhs.shape[1]
                bounds[(name, str(kind))] = (
                    _sym_bound(m, d, columns, str(kind), 4) if "sym" in name
                    else _rect_bound(m, m, d, columns, str(kind), 4))
                _log_bound(name, label, timing[(name, str(kind))][0],
                           bounds[(name, str(kind))])
        log("kernels", f"distance_matvec_sym {kind} / gram_matvec_sym rbf at m={m} "
            f"d={d}: {timing[('distance_matvec_sym', str(kind))][0] / a_ms:.3f}x the time "
            f"(kernel A {a_ms:.3f} ms in this call)")
    _yardstick(f"torch.cdist(X, X, p=1) m={m} d={d} f32",
               lambda: torch.cdist(X, X, p=1))
    return g_ms[60000]


def _chi2_per_entry(main_ms, phase, X, S, P, gamma):
    """Kernels E-H in float32 chi-squared at a main path's shapes (X the
    training rows, P the points against the support vectors S): each entry
    of K in MC_CLASSES columns, picked by one-hot right-hand sides, against
    the plain version in float64 on the same values (``entry_errors``),
    beside the float32 plain version's own worst error; and each kernel's
    share of its bound there (G and H as timed above, E and F timed here).
    Raises past 4x the plain version's error or 1e-4, as the card test
    does, or on a value that is not finite."""
    from plssvm_tpu_torch.ops import distance
    from plssvm_tpu_torch.ops.entry_check import entry_errors
    from plssvm_tpu_torch.parameter import KernelFunctionType as K

    m, d = X.shape
    columns = [int(j) for j in np.linspace(0, m - 1, MC_CLASSES)]
    e = torch.zeros(m, device="cuda")
    e[columns[1]] = 1.0
    kw = dict(kind=K.CHI_SQUARED, gamma=gamma)
    for name, kernel, points, one_column in (
        ("distance_matvec_sym", distance.distance_matvec_sym, None, True),
        ("distance_matvec_rect", distance.distance_matvec_rect, P, True),
        ("distance_matmat_sym", distance.distance_matmat_sym, None, False),
        ("distance_matmat_rect", distance.distance_matmat_rect, P, False),
    ):
        # the rectangular kernels' support vectors are S, whose first m
        # rows are X: the columns are those of K(P, S)
        rows = X if points is None else S
        got, plain = entry_errors(kernel, rows, columns, gamma, points=points,
                                  one_column=one_column)
        if not got <= min(4 * plain, 1e-4):
            raise AssertionError(f"{name} chi-squared {phase}: per-entry error {got}, "
                                 f"plain f32 {plain}")
        shape = f"{m}x{d}" if points is None else f"{P.shape[0]}x{S.shape[0]}x{d}"
        if "matmat" in name:
            ms, b_ms = main_ms[(name, phase)]
        else:
            args = (X, e) if points is None else (P, S, torch.zeros(S.shape[0], device="cuda"))
            ms = _median_ms(lambda: kernel(*args, **kw), 3, 1)
            b_ms = (_sym_bound(m, d, 1, "chi_squared", 4) if points is None
                    else _rect_bound(P.shape[0], S.shape[0], d, 1, "chi_squared", 4))[0]
            _check_share(name, f"chi-squared {shape}", ms, b_ms)
        log("kernels", f"per-entry {name} f32 chi-squared {shape} ({phase}), "
            f"{MC_CLASSES} columns of K: worst rel err {got:.3e}, plain f32 "
            f"{plain:.3e} ({got / plain:.2f}x); {ms:.3f} ms, {b_ms / ms:.3f} of "
            f"its bound {b_ms:.3f} ms")


def _banded_kernels(gen, main_err, main_ms, timing, bounds):
    """Kernel I against its plain version (each half) and kernel E (their
    sum) on ragged shapes, f32 and f64, both ``symmetric`` values; then at
    the banded tool's shape (phase 11), checked and timed beside kernel E
    on the same rows."""
    from plssvm_tpu_torch.ops import banded, distance, matvec
    from plssvm_tpu_torch.parameter import KernelFunctionType as K

    worst = {}
    for dtype in (torch.float32, torch.float64):
        for m, d in ((1, 1), (1, 3), (127, 3), (129, 203), (300, 1), (384, 16),
                     (1037, 203)):
            X = torch.rand(m, d, generator=gen, dtype=torch.float64).to("cuda", dtype)
            v = torch.randn(m, generator=gen, dtype=torch.float64).to("cuda", dtype)
            XT = X.T.contiguous()
            e = distance.distance_matvec_sym(X, v, kind=K.LAPLACIAN, gamma=1.0 / d)
            for symmetric in (True, False):
                label = f"banded_matvec {dtype} {m}x{d} symmetric={symmetric}"
                got = banded.banded_matvec(XT, v, 1.0 / d, symmetric=symmetric)
                want = matvec.banded_matvec_plain(XT, v, 1.0 / d, symmetric=symmetric)
                for half, g, w in zip(("out_r", "out_c"), got, want):
                    err, scale = _check_close(f"{label} {half}", g, w)
                    key = str(dtype).split(".")[-1]
                    worst[key] = max(worst.get(key, 0.0), err / max(scale, 1e-300))
                for g in ([got[0] + got[1]] if symmetric else got):
                    _check_close(f"{label} against kernel E", g, e)
    for dt, rel in sorted(worst.items()):
        log("kernels", f"banded_matvec {dt}: worst max|err|/max|plain| {rel:.3e} over "
            "7 shapes x both symmetric values x both halves; the halves agree "
            "with kernel E")

    # the banded tool's shape and data: |normal| rows, gamma = 1/d, f32
    m, d = BANDED_M, BANDED_D
    rng = np.random.default_rng(0)
    Xn = np.abs(rng.normal(size=(m, d))).astype(np.float32)
    XT = torch.as_tensor(np.ascontiguousarray(Xn.T), device="cuda")
    X = torch.as_tensor(Xn, device="cuda")
    v = torch.as_tensor(rng.normal(size=(m,)).astype(np.float32), device="cuda")
    gamma = float(np.float32(1.0 / d))
    got = banded.banded_matvec(XT, v, gamma)
    want = matvec.banded_matvec_plain(XT, v, gamma)
    errs = [_check_close(f"banded_matvec {m}x{d} {half}", g, w)
            for half, g, w in zip(("out_r", "out_c"), got, want)]
    main_err["banded_matvec"] = max(err for err, _ in errs)
    log("kernels", f"main-path shape f32 banded_matvec {m}x{d}: out_r max|err| "
        f"{errs[0][0]:.3e} (max|plain| {errs[0][1]:.3e}), out_c {errs[1][0]:.3e} "
        f"(max|plain| {errs[1][1]:.3e})")
    label = f"m={m} d={d} f32 laplacian"
    timing["banded_matvec"] = _time_pair(
        "banded_matvec", lambda XT, v, gamma: banded.banded_matvec(XT, v, gamma),
        lambda XT, v, gamma: matvec.banded_matvec_plain(XT, v, gamma),
        (XT, v, gamma), {}, float(m) * m * d, label,
        plain_repeats=DIST_PLAIN_REPEATS, unit="Tpair-feature/s", counted="m^2 d")
    bounds["banded_matvec"] = _sym_bound(m, d, 1, "laplacian", 4, extra_inputs=1)
    main_ms[("banded_matvec", "banded-tool")] = (timing["banded_matvec"][0],
                                                 bounds["banded_matvec"][0])
    _log_bound("banded_matvec", label, timing["banded_matvec"][0],
               bounds["banded_matvec"])
    e_ms = _median_ms(lambda: distance.distance_matvec_sym(
        X, v, kind=K.LAPLACIAN, gamma=gamma))
    log("kernels", f"banded_matvec / distance_matvec_sym at {label}: "
        f"{timing['banded_matvec'][0] / e_ms:.3f}x the time (kernel E {e_ms:.3f} "
        "ms in this call, median of 20)")
    _yardstick(f"torch.cdist(X, X, p=1) {label}", lambda: torch.cdist(X, X, p=1))


def _median_ms(fn, repeats=20, warmup=2):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def _time_pair(name, kernel, plain, args, kw, work, label, plain_repeats=20,
               unit="TFLOP/s", counted="2 m^2 d"):
    """Median ms of the kernel and of its plain version, in the order plain,
    kernel, kernel, plain: the two halves bracket any drift.  ``work`` is
    the count of ``counted``; the rates are 1e12 of it per second."""
    plain_warmup = 2 if plain_repeats >= 20 else 1
    p1 = _median_ms(lambda: plain(*args, **kw), plain_repeats, plain_warmup)
    k1 = _median_ms(lambda: kernel(*args, **kw))
    k2 = _median_ms(lambda: kernel(*args, **kw))
    p2 = _median_ms(lambda: plain(*args, **kw), plain_repeats, plain_warmup)
    k_ms, p_ms = min(k1, k2), min(p1, p2)
    log("kernels", f"{name} {label}: kernel {k_ms:.3f} ms "
        f"({k1:.3f}, {k2:.3f}) = {work / k_ms / 1e9:.2f} {unit}; plain "
        f"{p_ms:.3f} ms ({p1:.3f}, {p2:.3f}) = {work / p_ms / 1e9:.2f} "
        f"{unit} (counted as {counted}; plain: median of {plain_repeats} "
        f"after {plain_warmup} warm-up)")
    return k_ms, p_ms


def _bound(pairs, d, fmas, cost, n_bytes):
    """(ms, "operations" or "bytes"): the least time the card could take
    for a function that evaluates ``pairs`` kernel values over ``d``
    features at ``PAIR_FEATURE_COST[cost]`` each, contracts them in
    ``fmas`` FFMAs, and moves ``n_bytes`` (each input read once, each
    output written once) -- the larger of the operations over their peak
    rate and the bytes over the memory rate.  The per-pair epilogue (one
    exp or power) is not counted: 1/d of the pair work, it could only
    raise the bound."""
    fp32, sfu = PAIR_FEATURE_COST[cost]
    ops_s = max((fp32 * pairs * d + fmas) / FP32_INSTR_PER_S,
                sfu * pairs * d / SFU_OPS_PER_S)
    bytes_s = n_bytes / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


def _sym_bound(m, d, columns, cost, itemsize, extra_inputs=0):
    """The bound of ``K(X, X) @ V`` for X (m, d) and V (m, columns): the
    m (m + 1) / 2 distinct pairs of a symmetric kernel, m^2 FFMAs per
    column; X, V, the output and ``extra_inputs`` vectors of m moved."""
    return _bound(m * (m + 1) / 2, d, float(m) * m * columns, cost,
                  itemsize * m * (d + 2 * columns + extra_inputs))


def _rect_bound(n_p, n_s, d, columns, cost, itemsize, extra_inputs=0):
    """The bound of ``K(P, S) @ A`` for P (n_p, d), S (n_s, d) and A (n_s,
    columns): every pair, n_p n_s FFMAs per column."""
    return _bound(float(n_p) * n_s, d, float(n_p) * n_s * columns, cost,
                  itemsize * ((n_p + n_s) * (d + extra_inputs)
                              + (n_s + n_p) * columns))


def _check_share(name, label, k_ms, b_ms):
    """A kernel measured faster than its bound means a wrong bound or a
    wrong timing, never a fast kernel: raise."""
    if not k_ms >= b_ms:
        raise AssertionError(f"{name} {label}: {k_ms:.3f} ms is under its bound "
                             f"{b_ms:.3f} ms, a share of {b_ms / k_ms:.3f}")


def _log_bound(name, label, k_ms, bound, tf32_pairs_d=None):
    b_ms, by = bound
    _check_share(name, label, k_ms, b_ms)
    log("kernels", f"{name} {label}: bound {b_ms:.3f} ms ({by}), kernel at "
        f"{b_ms / k_ms:.3f} of it" + (
            "" if tf32_pairs_d is None else
            f"; TF32 tensor-core bound of the pair work, for information: "
            f"{2 * tf32_pairs_d / TF32_FLOP_PER_S * 1e3:.3f} ms"))


def _time_at_main_shape(main_ms, name, phase, fn, bound, label):
    """A kernel's median ms (5 after 1 warm-up) at the shape a main-path
    phase gives it, beside its bound there, for the cost ranking that
    ``main`` prints."""
    ms = _median_ms(fn, 5, 1)
    _check_share(name, f"at phase {phase}'s shape {label}", ms, bound[0])
    main_ms[(name, phase)] = (ms, bound[0])
    log("kernels", f"{name} at phase {phase}'s shape {label}: {ms:.3f} ms, bound "
        f"{bound[0]:.3f} ms ({bound[1]})")


def _yardstick(label, fn):
    """Log the median ms (5 after 1 warm-up) of one PyTorch call that
    computes a product only, not the kernel's function."""
    log("kernels", f"yardstick {label} (product only, not the same function): "
        f"{_median_ms(fn, 5, 1):.3f} ms")


def phase_kernels():
    from plssvm_tpu_torch.ops import gram_matmat, gram_matvec, matvec
    from plssvm_tpu_torch.parameter import KernelFunctionType as K

    gen = torch.Generator().manual_seed(SEED)
    kinds = ((K.POLYNOMIAL, 1.0), (K.RBF, 0.0), (K.SIGMOID, -0.5))
    worst = {}

    def check(X, P, v):
        for kind, coef0 in kinds:
            for name, (err, scale) in _compare(kind, coef0, X, P, v).items():
                key = (name, str(X.dtype).split(".")[-1])
                worst[key] = max(worst.get(key, 0.0), err / scale)

    for dtype in (torch.float32, torch.float64):
        for m, d in ((1037, 203), (8192, 512), (777, 1280), (129, 3)):
            check(*_operands(m, d, dtype, gen))
        # kernels C and D: 1 class, a few, and across the 8-class chunk
        for m, d in ((1037, 203), (777, 1280), (129, 3), (1, 5)):
            for n_classes in (1, 3, 10, 37):
                check(*_operands(m, d, dtype, gen, n_classes=n_classes))
        check(*_operands(8192, 512, dtype, gen, n_classes=10))
    for (name, dt), rel in sorted(worst.items()):
        log("kernels", f"{name} {dt}: worst max|err|/max|plain| {rel:.3e} "
            "over poly/rbf/sigmoid x 4 or 5 shapes"
            + (" x 1-37 classes" if "matmat" in name else ""))

    # the main path's own shapes: config 2 training (dept = 9999 rows) and
    # predict (2000 points against 10000 SVs), config 3 training
    main_err, main_ms = {}, {}
    X, P, v = _operands(9999, 200, torch.float32, gen, n_points=2000)
    cfg2 = _compare(K.RBF, 0.0, X, P, v)
    main_err["gram_matvec_sym"] = cfg2["gram_matvec_sym"][0]
    rbf = dict(kind=K.RBF, gamma=1.0 / 200, coef0=0.0, degree=3)
    sq = (X * X).sum(-1)
    _time_at_main_shape(main_ms, "gram_matvec_sym", "e2e",
                        lambda: gram_matvec.gram_matvec_sym(X, sq, v, **rbf),
                        _sym_bound(9999, 200, 1, "gram", 4, 1), "9999x200 rbf")
    X, P, v = _operands(10000, 200, torch.float32, gen, n_points=2000)
    main_err["gram_matvec_rect"] = _compare(K.RBF, 0.0, X, P, v)["gram_matvec_rect"][0]
    sq, sq_p = (X * X).sum(-1), (P * P).sum(-1)
    _time_at_main_shape(main_ms, "gram_matvec_rect", "e2e",
                        lambda: gram_matvec.gram_matvec_rect(P, X, sq_p, sq, v, **rbf),
                        _rect_bound(2000, 10000, 200, 1, "gram", 4, 1),
                        "2000x10000x200 rbf")
    X, P, v = _operands(49999, 500, torch.float32, gen, n_points=1)
    X = X / X.abs().amax(0)  # the [-1, 1] scale of config 3
    cfg3 = _compare(K.POLYNOMIAL, 0.0, X, P / P.abs().amax(0), v)
    sq = (X * X).sum(-1)
    _time_at_main_shape(
        main_ms, "gram_matvec_sym", "config3",
        lambda: gram_matvec.gram_matvec_sym(X, sq, v, kind=K.POLYNOMIAL,
                                            gamma=1.0 / 500, coef0=0.0, degree=3),
        _sym_bound(49999, 500, 1, "gram", 4, 1), "49999x500 poly")
    log("kernels", f"main-path shapes f32: sym 9999x200 rbf max|err| "
        f"{main_err['gram_matvec_sym']:.3e}, rect 2000x10000x200 rbf "
        f"{main_err['gram_matvec_rect']:.3e}, sym 49999x500 poly "
        f"{cfg3['gram_matvec_sym'][0]:.3e} (max|plain| "
        f"{cfg3['gram_matvec_sym'][1]:.3e})")
    # the multiclass paths' shapes, 10 classes: phase 5 training (9999
    # rows) and predict (2000 points against 10000 SVs), phase 7 training
    # (59999 x 784) and predict (10000 points against 60000 SVs)
    for (m, d, n_points) in ((9999, 200, 2000), (59999, 784, 10000)):
        X, P, V = _operands(m, d, torch.float32, gen, n_points=n_points,
                            n_classes=MC_CLASSES)
        sym_err = _compare(K.RBF, 0.0, X, P, V)["gram_matmat_sym"]
        S = torch.cat([X, X[:1]])  # the model keeps all m + 1 points
        rect_err = _compare(K.RBF, 0.0, S, P, torch.cat([V, V[:1]]))["gram_matmat_rect"]
        for name, (err, _) in (("gram_matmat_sym", sym_err),
                               ("gram_matmat_rect", rect_err)):
            main_err[name] = max(main_err.get(name, 0.0), err)
        phase = "multiclass" if m < 10000 else "mnist-width"
        rbf = dict(kind=K.RBF, gamma=1.0 / d, coef0=0.0, degree=3)
        sq, sq_p = (X * X).sum(-1), (P * P).sum(-1)
        S, A = torch.cat([X, X[:1]]), torch.cat([V, V[:1]])
        sq_s = (S * S).sum(-1)
        _time_at_main_shape(main_ms, "gram_matmat_sym", phase,
                            lambda: gram_matmat.gram_matmat_sym(X, sq, V, **rbf),
                            _sym_bound(m, d, MC_CLASSES, "gram", 4, 1),
                            f"{m}x{d} rbf C={MC_CLASSES}")
        _time_at_main_shape(main_ms, "gram_matmat_rect", phase,
                            lambda: gram_matmat.gram_matmat_rect(P, S, sq_p, sq_s, A, **rbf),
                            _rect_bound(n_points, m + 1, d, MC_CLASSES, "gram", 4, 1),
                            f"{n_points}x{m + 1}x{d} rbf C={MC_CLASSES}")
        log("kernels", f"main-path shapes f32, {MC_CLASSES} classes: sym "
            f"{m}x{d} rbf max|err| {sym_err[0]:.3e} (max|plain| "
            f"{sym_err[1]:.3e}), rect {n_points}x{m + 1}x{d} rbf "
            f"{rect_err[0]:.3e} (max|plain| {rect_err[1]:.3e})")

    # timing: median of 20 launches each, m = 32768, d = 512, f32, RBF;
    # kernels C and D against C = 10 classes
    m, d = 32768, 512
    X, _, v = _operands(m, d, torch.float32, gen, n_points=1)
    V = torch.randn(m, MC_CLASSES, generator=gen,
                    dtype=torch.float64).to("cuda", torch.float32)
    sq = (X * X).sum(-1)
    kw = dict(kind=K.RBF, gamma=1.0 / d, coef0=0.0, degree=3)
    flops = 2.0 * m * m * d
    timing = {}
    for rhs in (v, V):
        (sym_name, sym, sym_plain), (rect_name, rect, rect_plain) = _pairs(rhs)
        label = f"m={m} d={d} f32 rbf" + (
            f" C={rhs.shape[1]}" if rhs.ndim == 2 else "")
        timing[sym_name] = _time_pair(sym_name, sym, sym_plain, (X, sq, rhs),
                                      kw, flops, label)
        timing[rect_name] = _time_pair(rect_name, rect, rect_plain,
                                       (X, X, sq, sq, rhs), kw, flops, label)
    for mat, vec in (("gram_matmat_sym", "gram_matvec_sym"),
                     ("gram_matmat_rect", "gram_matvec_rect")):
        log("kernels", f"{mat} (C={MC_CLASSES}) / {vec} at m={m} d={d}: "
            f"{timing[mat][0] / timing[vec][0]:.3f}x the time")
    bounds = {}
    for rhs in (v, V):
        columns = 1 if rhs.ndim == 1 else rhs.shape[1]
        (sym_name, _, _), (rect_name, _, _) = _pairs(rhs)
        bounds[sym_name] = _sym_bound(m, d, columns, "gram", 4, extra_inputs=1)
        bounds[rect_name] = _rect_bound(m, m, d, columns, "gram", 4, extra_inputs=1)
        label = f"m={m} d={d} f32 rbf C={columns}"
        _log_bound(sym_name, label, timing[sym_name][0], bounds[sym_name],
                   m * (m + 1) / 2 * d)
        _log_bound(rect_name, label, timing[rect_name][0], bounds[rect_name],
                   float(m) * m * d)

    # K6's port: kernel_matvec, one launch of kernel A, at kernel A's shape
    timing["kernel_matvec"] = _time_pair(
        "kernel_matvec", gram_matvec.kernel_matvec, matvec.kernel_matvec_plain,
        (X, sq, v), kw, flops, f"m={m} d={d} f32 rbf")
    bounds["kernel_matvec"] = bounds["gram_matvec_sym"]
    _log_bound("kernel_matvec", f"m={m} d={d} f32 rbf", timing["kernel_matvec"][0],
               bounds["kernel_matvec"], m * (m + 1) / 2 * d)
    # full-precision float32 products, as the kernels compute
    torch.backends.cuda.matmul.allow_tf32 = False
    _yardstick(f"torch.matmul(X, X.T) m={m} d={d} f32", lambda: torch.matmul(X, X.T))
    # kernel_matvec on bench_matvec's shape (phase 12), RBF, against its
    # plain version; on one tile (m <= 64: one atomic per row, so a
    # fixed summation order) it equals kernel A bit for bit
    Xb, _, vb = _operands(BENCH_M, BENCH_D, torch.float32, gen, n_points=1)
    kwb = dict(kind=K.RBF, gamma=1.0 / BENCH_D, coef0=0.0, degree=3)
    sqb = (Xb * Xb).sum(-1)
    main_err["kernel_matvec"] = _check_close(
        f"kernel_matvec rbf {BENCH_M}x{BENCH_D}",
        gram_matvec.kernel_matvec(Xb, sqb, vb, **kwb),
        matvec.kernel_matvec_plain(Xb, sqb, vb, **kwb))[0]
    _time_at_main_shape(main_ms, "kernel_matvec", "bench-matvec",
                        lambda: gram_matvec.kernel_matvec(Xb, sqb, vb, **kwb),
                        _sym_bound(BENCH_M, BENCH_D, 1, "gram", 4, 1),
                        f"{BENCH_M}x{BENCH_D} rbf")
    X1, _, v1 = _operands(64, 37, torch.float32, gen, n_points=1)
    sq1 = (X1 * X1).sum(-1)
    if not torch.equal(gram_matvec.kernel_matvec(X1, sq1, v1, **kwb),
                       gram_matvec.gram_matvec_sym(X1, sq1, v1, **kwb)):
        raise AssertionError("kernel_matvec differs from kernel A on one tile")
    log("kernels", f"kernel_matvec rbf {BENCH_M}x{BENCH_D} f32: max|err| "
        f"{main_err['kernel_matvec']:.3e} against the plain version; equal to "
        "kernel A bit for bit on one tile (64 x 37)")

    def time_a(X16):
        """Kernel A alone on the distance timing's rows, RBF."""
        sq16 = (X16 * X16).sum(-1)
        v16 = torch.ones(X16.shape[0], device="cuda", dtype=X16.dtype)
        kw16 = dict(kind=K.RBF, gamma=1.0 / X16.shape[1], coef0=0.0, degree=3)
        a_ms = _median_ms(lambda: gram_matvec.gram_matvec_sym(X16, sq16, v16, **kw16))
        log("kernels", f"gram_matvec_sym m={X16.shape[0]} d={X16.shape[1]} f32 rbf: "
            f"{a_ms:.3f} ms")
        return a_ms

    g_chi_ms = _distance_kernels(gen, main_err, main_ms, timing, bounds, time_a)
    _banded_kernels(gen, main_err, main_ms, timing, bounds)
    return main_err, main_ms, timing, bounds, g_chi_ms


def _write_config2(tmp):
    """Seeded overlapping two-class 10000 x 200 train and 2000 x 200 test
    files, written with the port's LIBSVM writer."""
    from plssvm_tpu_torch import DataSet

    start = time.perf_counter()
    rng = np.random.default_rng(SEED)
    paths = []
    for name, n in (("train", 10000), ("test", 2000)):
        y = np.where(rng.random(n) < 0.5, -1, 1)
        X = rng.normal(size=(n, 200)) + 0.1 * y[:, None]
        path = os.path.join(tmp, f"{name}.libsvm")
        DataSet(X, y).save(path)
        paths.append((path, y))
    log("e2e", f"wrote 10000x200 + 2000x200 LIBSVM files in "
        f"{time.perf_counter() - start:.2f} s")
    return paths


def _tracked(category, name):
    from plssvm_tpu_torch import global_tracker

    values = [v for n, v in global_tracker.entries().get(category, []) if n == name]
    return values[-1]


def _cli_fit_predict(phase, train_file, test_file, tmp, flags):
    """Train and predict through the port's CLIs on the card; returns
    (fit seconds, predict seconds, predicted labels)."""
    import plssvm_tpu_torch as port
    from plssvm_tpu_torch.cli import predict as predict_cli
    from plssvm_tpu_torch.cli import train as train_cli

    model_file = os.path.join(tmp, f"{phase}.model")
    out_file = os.path.join(tmp, f"{phase}.predict")
    common = ["-b", "cuda", "-p", "gpu", "-q"]
    port.global_tracker.clear()
    t0 = time.perf_counter()
    rc = train_cli.main(common + flags + [train_file, model_file])
    t1 = time.perf_counter()
    rc_predict = predict_cli.main(common + [test_file, model_file, out_file])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if rc != 0 or rc_predict != 0:
        raise AssertionError(f"{phase}: train rc {rc}, predict rc {rc_predict}")
    with open(out_file, encoding="utf-8") as fh:
        predicted = np.asarray([int(line) for line in fh])
    return t1 - t0, t2 - t1, predicted


def _check_cli_run(phase, label, fit_s, predict_s, accuracy, floor, launches,
                   plain_calls, sym_name, rect_name):
    """Log a CLI run and check it: the symmetric kernel launched once for
    the initial residual, once per iteration and once more every 50th; the
    rectangular one at least once; no plain version called; the accuracy
    floor met."""
    iterations = _tracked("cg", "iterations")
    cg_ms = _tracked("cg", "total_runtime")
    per_class = _tracked("cg", "iterations_per_class") if "matmat" in sym_name else None
    log(phase, f"{label} f32 (cuda): {iterations} CG iterations"
        + (f" (per class {per_class})" if per_class else "")
        + f", {cg_ms / 1000 / iterations:.6f} s/iteration, CG {cg_ms / 1000:.3f} s, "
        f"fit (CLI, parse included) {fit_s:.3f} s, predict (CLI) {predict_s:.3f} s, "
        f"accuracy {accuracy:.4f}, launches {launches}, plain calls {plain_calls}")
    if launches[sym_name] != 1 + iterations + iterations // 50:
        raise AssertionError(f"{sym_name} launched {launches[sym_name]} times "
                             f"for {iterations} iterations")
    if launches[rect_name] <= 0 or plain_calls != 0:
        raise AssertionError(f"{phase}: predict did not go through {rect_name} only")
    if accuracy < floor:
        raise AssertionError(f"accuracy {accuracy} below {floor}")


def _f64_agreement(phase, label, train_file, test_file, predicted, epsilon, **params):
    """A float64 fit on the card from the same files must predict the
    float32 run's labels on >= 99.5 % of the points."""
    import plssvm_tpu_torch as port

    train64 = port.DataSet(train_file, dtype=np.float64)
    test64 = port.DataSet(test_file, dtype=np.float64)
    svm64 = port.CSVM(backend="cuda", device="cuda", dtype=np.float64,
                      cost=1.0, **params)
    t0 = time.perf_counter()
    model64 = svm64.fit(train64, epsilon=epsilon)
    t1 = time.perf_counter()
    agree = float(np.mean(svm64.predict(model64, test64) == predicted))
    log(phase, f"{label} f64 (cuda): {model64.n_iter} CG iterations, fit "
        f"{t1 - t0:.3f} s, f32/f64 label agreement {agree:.4f}")
    if agree < 0.995:
        raise AssertionError(f"f32 and f64 agree on {agree} of the labels")


def _small_fit_agreement(phase, kernel_type, n_classes, seed):
    """A small float64 problem (400 x 10, 300 train): the CUDA kernels and
    the plain versions on the card give the same model and decision values."""
    import plssvm_tpu_torch as port

    rng = np.random.default_rng(seed)
    if n_classes == 2:
        y = np.where(rng.random(400) < 0.5, -1, 1)
        X = rng.normal(size=(400, 10)) + 0.4 * y[:, None]
    else:
        y = rng.integers(0, n_classes, 400)
        X = rng.normal(size=(400, 10)) + rng.normal(size=(n_classes, 10))[y]
    train = port.DataSet(X[:300], y[:300], scaling=(-1.0, 1.0))
    test = port.DataSet(X[300:], y[300:], scaling=train.scaling_factors)
    values = []
    for backend in ("cuda", "torch"):
        svm = port.CSVM(backend=backend, device="cuda", dtype=np.float64,
                        kernel_type=kernel_type, cost=1.0)
        model = svm.fit(train, epsilon=1e-10)
        values.append((np.asarray(model.rho), svm.predict_values(model, test)))
    drho = float(np.max(np.abs(values[0][0] - values[1][0])))
    dval = float(np.max(np.abs(values[0][1] - values[1][1])))
    log(phase, f"small {n_classes}-class f64 {kernel_type} fit, kernels vs plain "
        f"on the card: max|d rho| {drho:.3e}, max|d f(x)| {dval:.3e}")
    # the kernels' atomics reorder sums from run to run, and CG amplifies
    # that rounding noise (ROADMAP Queue 3); 1e-6 on O(1) values still
    # catches any real difference between the two paths
    if not (np.all(np.isfinite(values[0][1])) and drho <= 1e-6 and dval <= 1e-6):
        raise AssertionError(f"{phase}: kernels and plain versions disagree")


def _distance_counts():
    from plssvm_tpu_torch.ops import distance, matvec

    return {
        "distance_matvec_sym": distance.matvec_sym_launches,
        "distance_matvec_rect": distance.matvec_rect_launches,
        "distance_matmat_sym": distance.matmat_sym_launches,
        "distance_matmat_rect": distance.matmat_rect_launches,
    }, (matvec.dist_sym_plain_calls + matvec.dist_rect_plain_calls
        + matvec.dist_sym_matmat_plain_calls + matvec.dist_rect_matmat_plain_calls)


def phase_end_to_end(tmp, config2_files):
    from plssvm_tpu_torch.ops import gram_matvec, matvec

    (train_file, _), (test_file, test_labels) = config2_files
    gram_matvec.reset_counts()
    fit_s, predict_s, predicted = _cli_fit_predict(
        "e2e", train_file, test_file, tmp,
        ["-t", "2", "-c", "1", "-e", str(EPSILON)])
    launches = {
        "gram_matvec_sym": gram_matvec.sym_launches,
        "gram_matvec_rect": gram_matvec.rect_launches,
    }
    _check_cli_run("e2e", "config 2", fit_s, predict_s,
                   float(np.mean(predicted == test_labels)), ACCURACY_FLOOR,
                   launches, matvec.sym_plain_calls + matvec.rect_plain_calls,
                   "gram_matvec_sym", "gram_matvec_rect")
    _f64_agreement("e2e", "config 2", train_file, test_file, predicted,
                   EPSILON, kernel_type="rbf")
    _small_fit_agreement("e2e", "rbf", 2, SEED + 1)
    return launches


def _class_means(rng, d):
    """MC_CLASSES seeded class means whose pairwise distances average
    MC_SEPARATION."""
    return rng.normal(size=(MC_CLASSES, d)) * (MC_SEPARATION / np.sqrt(2 * d))


def _draw(rng, means, n):
    """n points of the isotropic unit Gaussian classes around ``means``."""
    labels = rng.integers(0, len(means), n)
    return rng.normal(size=(n, means.shape[1])) + means[labels], labels


def phase_multiclass_cli(tmp):
    from plssvm_tpu_torch import DataSet
    from plssvm_tpu_torch.ops import gram_matmat, gram_matvec, matvec

    start = time.perf_counter()
    rng = np.random.default_rng(SEED + 3)
    means = _class_means(rng, 200)
    files = {}
    for name, n in (("mc_train", 10000), ("mc_test", 2000)):
        X, y = _draw(rng, means, n)
        files[name] = (os.path.join(tmp, f"{name}.libsvm"), y)
        DataSet(X, y).save(files[name][0])
    train_file, test_file = files["mc_train"][0], files["mc_test"][0]
    log("multiclass", f"wrote {MC_CLASSES}-class 10000x200 + 2000x200 LIBSVM "
        f"files in {time.perf_counter() - start:.2f} s")
    gram_matvec.reset_counts()
    gram_matmat.reset_counts()
    fit_s, predict_s, predicted = _cli_fit_predict(
        "multiclass", train_file, test_file, tmp,
        ["-t", "2", "-c", "1", "-e", str(EPSILON)])
    launches = {
        "gram_matmat_sym": gram_matmat.sym_launches,
        "gram_matmat_rect": gram_matmat.rect_launches,
    }
    if gram_matvec.sym_launches + gram_matvec.rect_launches != 0:
        raise AssertionError("multiclass launched the binary kernels")
    _check_cli_run("multiclass", f"{MC_CLASSES} classes", fit_s, predict_s,
                   float(np.mean(predicted == files["mc_test"][1])),
                   MC_ACCURACY_FLOOR, launches,
                   matvec.sym_matmat_plain_calls + matvec.rect_matmat_plain_calls,
                   "gram_matmat_sym", "gram_matmat_rect")
    _f64_agreement("multiclass", f"{MC_CLASSES} classes", train_file, test_file,
                   predicted, EPSILON, kernel_type="rbf")
    _small_fit_agreement("multiclass", "rbf", 4, SEED + 5)
    return launches


def phase_multiclass_width():
    import plssvm_tpu_torch as port
    from plssvm_tpu_torch.ops import gram_matmat, matvec

    start = time.perf_counter()
    rng = np.random.default_rng(SEED + 4)
    means = _class_means(rng, 784)
    X, y = _draw(rng, means, 60000)
    X_test, y_test = _draw(rng, means, 10000)
    train = port.DataSet(X, y, dtype=np.float32)
    test = port.DataSet(X_test, y_test, dtype=np.float32)
    log("mnist-width", f"made {MC_CLASSES}-class 60000x784 + 10000x784 in "
        f"memory in {time.perf_counter() - start:.2f} s")
    svm = port.CSVM(backend="cuda", device="cuda", dtype=np.float32,
                    kernel_type="rbf", cost=1.0)
    port.global_tracker.clear()
    gram_matmat.reset_counts()
    t0 = time.perf_counter()
    model = svm.fit(train, epsilon=EPSILON)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    predicted = svm.predict(model, test)
    t2 = time.perf_counter()
    launches = (gram_matmat.sym_launches, gram_matmat.rect_launches)
    plain_calls = matvec.sym_matmat_plain_calls + matvec.rect_matmat_plain_calls
    iterations = _tracked("cg", "iterations")
    cg_ms = _tracked("cg", "total_runtime")
    accuracy = float(np.mean(predicted == y_test))
    log("mnist-width", f"rbf 60000x784 {MC_CLASSES} classes f32 (cuda): "
        f"{iterations} block-CG iterations (per class "
        f"{_tracked('cg', 'iterations_per_class')}), "
        f"{cg_ms / 1000 / iterations:.6f} s/iteration, fit {t1 - t0:.3f} s, "
        f"predict 10000 points {t2 - t1:.3f} s, accuracy {accuracy:.4f}, "
        f"kernel C/D launches {launches}, matmat plain calls {plain_calls}")
    if not (np.all(np.isfinite(model.alpha)) and np.all(np.isfinite(model.rho))):
        raise AssertionError("MNIST width: non-finite model")
    if launches[0] != 1 + iterations + iterations // 50 or launches[1] <= 0 \
            or plain_calls != 0:
        raise AssertionError("MNIST width did not go through kernels C and D only")
    if accuracy < MC_ACCURACY_FLOOR:
        raise AssertionError(f"accuracy {accuracy} below {MC_ACCURACY_FLOOR}")
    return {"gram_matmat_sym": launches[0], "gram_matmat_rect": launches[1]}


def phase_config3_width():
    import plssvm_tpu_torch as port
    from plssvm_tpu_torch.ops import gram_matvec

    rng = np.random.default_rng(SEED + 2)
    n, d = 50000, 500
    y = np.where(rng.random(n) < 0.5, -1, 1)
    X = rng.normal(size=(n, d)) + 0.05 * y[:, None]
    data = port.DataSet(X, y, scaling=(-1.0, 1.0), dtype=np.float32)
    svm = port.CSVM(backend="cuda", device="cuda", dtype=np.float32,
                    kernel_type="polynomial")
    port.global_tracker.clear()
    gram_matvec.reset_counts()
    t0 = time.perf_counter()
    model = svm.fit(data, epsilon=1e-12, max_iter=20)
    t1 = time.perf_counter()
    iterations = _tracked("cg", "iterations")
    cg_ms = _tracked("cg", "total_runtime")
    if not np.all(np.isfinite(model.alpha)) or not np.isfinite(model.rho):
        raise AssertionError("config 3 width: non-finite model")
    log("config3", f"poly 50000x500 f32 (cuda): {iterations} CG iterations, "
        f"{cg_ms / 1000 / iterations:.6f} s/iteration, fit {t1 - t0:.3f} s, "
        f"kernel A launches {gram_matvec.sym_launches}")
    return {"gram_matvec_sym": gram_matvec.sym_launches}


def phase_laplacian_cli(tmp, config2_files):
    """Phase 8: phase 4's config 2 files with -t 4: only the kernel
    differs from phase 4."""
    from plssvm_tpu_torch.ops import distance

    (train_file, _), (test_file, test_labels) = config2_files
    distance.reset_counts()
    fit_s, predict_s, predicted = _cli_fit_predict(
        "laplacian", train_file, test_file, tmp,
        ["-t", "4", "-c", "1", "-e", str(EPSILON)])
    launches, plain_calls = _distance_counts()
    _check_cli_run("laplacian", "config 2 -t 4", fit_s, predict_s,
                   float(np.mean(predicted == test_labels)),
                   LAPLACIAN_ACCURACY_FLOOR, launches, plain_calls,
                   "distance_matvec_sym", "distance_matvec_rect")
    _f64_agreement("laplacian", "config 2 -t 4", train_file, test_file,
                   predicted, EPSILON, kernel_type="laplacian")
    _small_fit_agreement("laplacian", "laplacian", 2, SEED + 11)
    return {k: launches[k] for k in ("distance_matvec_sym", "distance_matvec_rect")}


def phase_chi2_cli(tmp):
    """Phase 9: 10 histogram classes at config 2's shape, -t 5."""
    from plssvm_tpu_torch import DataSet
    from plssvm_tpu_torch.ops import distance

    rng = np.random.default_rng(SEED + 12)
    probs = _histogram_classes(rng, 200)
    start = time.perf_counter()
    X, y, _ = _draw_histograms(rng, probs, 10000)
    X_test, y_test, _ = _draw_histograms(rng, probs, 2000)
    train_file = os.path.join(tmp, "chi2_train.libsvm")
    test_file = os.path.join(tmp, "chi2_test.libsvm")
    DataSet(X, y).save(train_file)
    DataSet(X_test, y_test).save(test_file)
    gamma = _chi2_gamma(rng, X)
    bayes = _bayes_accuracy(rng, probs)
    log("chi2-cli", f"wrote {MC_CLASSES}-class 10000x200 + 2000x200 histogram "
        f"files ({np.mean(X == 0):.3f} of the entries 0) in "
        f"{time.perf_counter() - start:.2f} s; gamma {gamma:.6f} (1 / mean "
        f"chi-squared distance); Bayes-optimal accuracy {bayes:.4f} (Monte "
        "Carlo, 20000 draws)")
    distance.reset_counts()
    fit_s, predict_s, predicted = _cli_fit_predict(
        "chi2-cli", train_file, test_file, tmp,
        ["-t", "5", "-g", repr(gamma), "-c", "1", "-e", str(CHI2_EPSILON)])
    launches, plain_calls = _distance_counts()
    _check_cli_run("chi2-cli", f"{MC_CLASSES} classes -t 5", fit_s, predict_s,
                   float(np.mean(predicted == y_test)), CHI2_ACCURACY_FLOOR,
                   launches, plain_calls, "distance_matmat_sym",
                   "distance_matmat_rect")
    _f64_agreement("chi2-cli", f"{MC_CLASSES} classes -t 5", train_file,
                   test_file, predicted, CHI2_EPSILON,
                   kernel_type="chi_squared", gamma=gamma)
    return {k: launches[k] for k in ("distance_matmat_sym", "distance_matmat_rect")}


def phase_chi2_width(g_chi_ms):
    """Phase 10: the histogram classes at MNIST's width, count and split,
    through CSVM in memory; max_iter capped from kernel G's time."""
    import plssvm_tpu_torch as port
    from plssvm_tpu_torch.ops import distance

    rng = np.random.default_rng(SEED + 13)
    probs = _histogram_classes(rng, 784)
    start = time.perf_counter()
    X, y, _ = _draw_histograms(rng, probs, 60000)
    X_test, y_test, _ = _draw_histograms(rng, probs, 10000)
    gamma = _chi2_gamma(rng, X)
    bayes = _bayes_accuracy(rng, probs)
    train = port.DataSet(X, y, dtype=np.float32)
    test = port.DataSet(X_test, y_test, dtype=np.float32)
    # kernel G at this shape, from the kernels phase; the iteration costs
    # one launch and the loop around it
    per_launch = g_chi_ms / 1000
    max_iter = max(5, int(CHI_WIDTH_CG_SECONDS / per_launch) - 2)
    log("chi2-width", f"made {MC_CLASSES}-class 60000x784 + 10000x784 histograms "
        f"({np.mean(X == 0):.3f} of the entries 0) in {time.perf_counter() - start:.2f} s; "
        f"gamma {gamma:.6f}; Bayes-optimal accuracy {bayes:.4f}; kernel G "
        f"{per_launch:.3f} s per launch (kernels phase), max_iter {max_iter}")
    svm = port.CSVM(backend="cuda", device="cuda", dtype=np.float32,
                    kernel_type="chi_squared", gamma=gamma, cost=1.0)
    port.global_tracker.clear()
    distance.reset_counts()
    t0 = time.perf_counter()
    model = svm.fit(train, epsilon=CHI_WIDTH_EPSILON, max_iter=max_iter)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    predicted = svm.predict(model, test)
    t2 = time.perf_counter()
    launches, plain_calls = _distance_counts()
    iterations = _tracked("cg", "iterations")
    cg_ms = _tracked("cg", "total_runtime")
    converged = _tracked("cg", "residuum") <= _tracked("cg", "target_residuum")
    accuracy = float(np.mean(predicted == y_test))
    log("chi2-width", f"chi-squared 60000x784 {MC_CLASSES} classes f32 (cuda): "
        f"{iterations} block-CG iterations (per class "
        f"{_tracked('cg', 'iterations_per_class')}), reached epsilon {CHI_WIDTH_EPSILON}: "
        f"{converged}, {cg_ms / 1000 / iterations:.6f} s/iteration, fit "
        f"{t1 - t0:.3f} s, predict 10000 points {t2 - t1:.3f} s, accuracy "
        f"{accuracy:.4f}, kernel G/H launches ({launches['distance_matmat_sym']}, "
        f"{launches['distance_matmat_rect']}), distance plain calls {plain_calls}")
    if not (np.all(np.isfinite(model.alpha)) and np.all(np.isfinite(model.rho))):
        raise AssertionError("chi-squared width: non-finite model")
    if launches["distance_matmat_sym"] != 1 + iterations + iterations // 50 \
            or launches["distance_matmat_rect"] <= 0 or plain_calls != 0:
        raise AssertionError("chi-squared width did not go through kernels G and H only")
    if converged and accuracy < CHI2_ACCURACY_FLOOR:
        raise AssertionError(f"accuracy {accuracy} below {CHI2_ACCURACY_FLOOR}")
    return {k: launches[k] for k in ("distance_matmat_sym", "distance_matmat_rect")}


def _run_tool(phase, main, argv):
    """Run a tool's ``main(argv)`` in this process, its output logged under
    ``phase``; returns the output's lines, raises unless it exits 0."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    lines = out.getvalue().strip().splitlines()
    for line in lines:
        log(phase, line)
    if rc != 0:
        raise AssertionError(f"{phase}: {' '.join(argv) or 'defaults'} exited {rc}")
    return lines


def phase_banded_tool():
    """Phase 11: the banded tool at its defaults, then with --check; kernel
    I launched for each product and nothing through its plain version."""
    from plssvm_tpu_torch.ops import banded, matvec
    from plssvm_tpu_torch.tools import exp_banded_distance

    banded.reset_counts()
    lines = _run_tool("banded-tool", exp_banded_distance.main, [])
    _run_tool("banded-tool", exp_banded_distance.main, ["--check"])
    launches, plain_calls = banded.launches, matvec.banded_plain_calls
    log("banded-tool", f"kernel I launches {launches}, plain calls {plain_calls}")
    # an untimed and a timed loop of BANDED_ITERS products, and the check
    if launches != 2 * BANDED_ITERS + 1 or plain_calls != 0:
        raise AssertionError("the banded tool did not go through kernel I only")
    if not lines[-1].startswith("banded: "):
        raise AssertionError(f"banded tool printed {lines[-1]!r}")
    return {"banded_matvec": launches}


def phase_bench_matvec():
    """Phase 12: bench_matvec at BENCH_M x BENCH_D for RBF and laplacian;
    every variant's rel_err against the float64 golden within 1e-5, and
    each kernel launched once for the check and 3 x BENCH_ITERS times."""
    from plssvm_tpu_torch.ops import distance, gram_matvec, matvec
    from plssvm_tpu_torch.tools import bench_matvec

    gram_matvec.reset_counts()
    distance.reset_counts()
    for kernel in ("rbf", "laplacian"):
        lines = _run_tool("bench-matvec", bench_matvec.main,
                          [str(BENCH_M), str(BENCH_D), str(BENCH_ITERS), "all", kernel])
        for line in lines[1:]:
            if "not ported" in line:
                continue
            rel = float(line.rsplit("rel_err=", 1)[1])
            if not rel <= 1e-5:
                raise AssertionError(f"bench_matvec {kernel}: {line}")
    per_variant = 1 + 3 * BENCH_ITERS
    launches = {
        "kernel_matvec": gram_matvec.kernel_matvec_launches,
        "gram_matvec_sym": gram_matvec.sym_launches,
        "gram_matvec_rect": gram_matvec.rect_launches,
        "distance_matvec_sym": distance.matvec_sym_launches,
    }
    log("bench-matvec", f"launches {launches}; plain calls: Gram "
        f"{matvec.sym_plain_calls}, distance {matvec.dist_sym_plain_calls}")
    # kernel_matvec and kernel_matvec_hi are kernel A's only callers here
    if launches != {"kernel_matvec": 2 * per_variant, "gram_matvec_sym": 2 * per_variant,
                    "gram_matvec_rect": per_variant, "distance_matvec_sym": per_variant} \
            or matvec.sym_plain_calls != per_variant \
            or matvec.dist_sym_plain_calls != per_variant:
        raise AssertionError("bench_matvec's variants did not launch as expected")
    return {"kernel_matvec": launches["kernel_matvec"]}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available.",
              file=sys.stderr)
        return 1
    import plssvm_tpu_torch

    plssvm_tpu_torch.set_verbosity("quiet")
    torch.manual_seed(SEED)
    phase_seconds = {}

    def run(phase, fn, *args):
        start = time.perf_counter()
        result = fn(*args)
        phase_seconds[phase] = time.perf_counter() - start
        return result

    name, smi = run("device", phase_device)
    run("build", phase_build)
    main_err, main_ms, timing, bounds, g_chi_ms = run("kernels", phase_kernels)
    # per main-path phase, each kernel's launches in that phase's run
    phase_launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        config2_files = _write_config2(tmp)
        phase_launches["e2e"] = run("e2e", phase_end_to_end, tmp, config2_files)
        phase_launches["multiclass"] = run("multiclass", phase_multiclass_cli, tmp)
        phase_launches["laplacian"] = run("laplacian", phase_laplacian_cli, tmp,
                                          config2_files)
        phase_launches["chi2-cli"] = run("chi2-cli", phase_chi2_cli, tmp)
    phase_launches["config3"] = run("config3", phase_config3_width)
    phase_launches["mnist-width"] = run("mnist-width", phase_multiclass_width)
    phase_launches["chi2-width"] = run("chi2-width", phase_chi2_width, g_chi_ms)
    phase_launches["banded-tool"] = run("banded-tool", phase_banded_tool)
    phase_launches["bench-matvec"] = run("bench-matvec", phase_bench_matvec)
    log("times", ", ".join(f"{k} {v:.1f} s" for k, v in phase_seconds.items()))

    # where the kernels lose time on the main paths: launches x (ms at the
    # phase's shape - bound there), largest first
    costs = sorted(
        ((n * (main_ms[(k, phase)][0] - main_ms[(k, phase)][1]), k, phase, n)
         for phase, counts in phase_launches.items() for k, n in counts.items()
         if (k, phase) in main_ms),
        reverse=True)
    for lost, k, phase, n in costs:
        ms, b_ms = main_ms[(k, phase)]
        log("cost", f"{k} in {phase}: {n} launches x ({ms:.3f} - {b_ms:.3f}) ms "
            f"= {lost:.1f} ms above the bound")
    # each kernel's launches in the JSON line are those of the first phase
    # that runs it
    launches = {}
    for counts in phase_launches.values():
        for k, n in counts.items():
            launches.setdefault(k, n)

    # the distance kernels report the kind their main path ran: laplacian
    # for E and F (phase 8), chi-squared for G and H (phases 9 and 10);
    # kernel_matvec's launches are phase 12's, kernel I's phase 11's.  No
    # single PyTorch call computes any kernel's function (library_ms)
    sources = {
        "gram_matvec_sym": ("gram_matvec.cu", "plssvm_tpu/ops/pallas_matvec.py:430"),
        "gram_matvec_rect": ("gram_matvec.cu", "plssvm_tpu/ops/pallas_matvec.py:1007"),
        "gram_matmat_sym": ("gram_matmat.cu", "plssvm_tpu/ops/pallas_matvec.py:812"),
        "gram_matmat_rect": ("gram_matmat.cu", "plssvm_tpu/ops/pallas_matvec.py:812"),
        ("distance_matvec_sym", "laplacian"): (
            "distance.cu", "plssvm_tpu/ops/pallas_distance.py:226"),
        ("distance_matvec_rect", "laplacian"): (
            "distance.cu", "plssvm_tpu/ops/pallas_distance.py:226"),
        ("distance_matmat_sym", "chi_squared"): (
            "distance.cu", "plssvm_tpu/ops/pallas_distance.py:412"),
        ("distance_matmat_rect", "chi_squared"): (
            "distance.cu", "plssvm_tpu/ops/pallas_distance.py:412"),
        "kernel_matvec": ("gram_matvec.cu", "plssvm_tpu/ops/pallas_matvec.py:984"),
        "banded_matvec": ("banded.cu", "tools/exp_banded_distance.py:107"),
    }
    print(smi)
    print(json.dumps({"kernels": [
        {
            "name": k if isinstance(k, str) else k[0], "route": "cuda",
            "source": f"plssvm_tpu_torch/csrc/{src}",
            "replaces": replaces,
            "launches": launches[k if isinstance(k, str) else k[0]],
            "max_abs_err": main_err[k], "ms": timing[k][0],
            "plain_ms": timing[k][1], "bound_ms": bounds[k][0],
            "bound_by": bounds[k][1], "library_ms": None,
        }
        for k, (src, replaces) in sources.items()
    ]}))
    # every phase ran on device 0 alone
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": 1,
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
