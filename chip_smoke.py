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
   paths' own shapes, at each Gram tier: "highest" on the FFMA tile; at
   "f32" (TF32) and "bf16" A and C on the symmetric tensor-core tile
   (``*_sym_tc``), B and D on the rectangular one (``*_rect_tc``), held
   against the plain version on the tier's operands, and B and D at "f32"
   against full float32 within the first-order TF32 bound; in float64, at
   every tier, A-D on the FP64 tensor cores (the symmetric DMMA tile,
   ``*_sym_dmma``, and the rect one, ``*_rect_dmma``); then all timed against
   their plain versions, beside the operand copies' time and torch.matmul
   yardsticks in float32, TF32, bf16 and float64;
4. end to end, BASELINE config 2: RBF on a seeded two-class 10000 x 200
   set, trained with plssvm-torch-train (the default "f32" tier: kernel A
   on the tensor cores) and scored with plssvm-torch-predict on 2000
   held-out points (kernel B on the tensor cores); the kernels' launch
   counts prove the path went through them; a float64 fit and predict
   (kernels A and B on the DMMA tiles) must agree with the
   float32 one; a small float64 fit must agree between the kernels and the
   plain versions;
5. multiclass end to end: the same shape with 10 classes, one-vs-all,
   through both CLIs; kernels C and D's launch counts, accuracy against a
   floor, float32/float64 agreement (float64: C and D on the DMMA tiles),
   and a small float64 fit through the kernels against the
   plain versions;
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
   laplacian (kernel E beside the plain version);
13. the ring: ``CSVM(devices=["cuda:0"] * 4)``, four row shards on the one
   card, fits and predicts binary RBF at config 3's width (50000 x 500:
   kernels A, J, B), phase 7's 10 classes at MNIST width (C, K, D), phase
   8's laplacian files (E, L, F) and phase 9's histogram classes (G, M, H),
   each against its single-device run, in float32 and float64 (the
   symmetric products, J and K, and the rows-only B and D on the DMMA
   tiles): iterations,
   s/iteration, the launches of every kernel, epsilon reached, the
   accuracy floor, label agreement >= 0.999, and the ring's operand copies
   per iteration.

The "bf16" phase runs right after phase 5, on the files of phases 4 and
5: both trained through ``plssvm-torch-train --gram_precision bf16`` and
predicted through ``CSVM(gram_precision="bf16")`` (kernels A-D on the
tensor-core tiles with bf16 operands), accuracy floors as
phases 4 and 5, label agreement with the "f32" runs logged.  Phases 8 and
9 follow, then 6, 7, 10 and 13 while phase 8 and 9's files exist, then
phases 11 and 12.

Phase 3 also holds kernels E-H (laplacian / chi-squared matvecs and block
matmats, csrc/distance.cu) against their plain versions on ragged shapes
with non-negative, zero-rich data and at phases 8-10's shapes, and times
them there and, beside kernel A, at m = 16384, d = 256; kernel I (the
banded laplacian matvec, csrc/banded.cu) against its plain version and
kernel E on ragged shapes and at phase 11's shape, where it is timed
beside kernel E; and ``kernel_matvec`` against kernel A and its plain
version, timed at kernel A's shape; and kernels J-M (the ring's dual
walks: csrc/dual.cu, J and K at "f32" and "bf16" on the dual tensor-core
tile of csrc/gram_tc.cuh, whose blocks per SM it logs, and in float64 on
the dual DMMA tile of csrc/gram_dmma.cu), both outputs, against their
plain versions on ragged mr != mc blocks in float32 and float64, J and K
at each Gram tier, L and M per entry of K in float32 chi-squared, then
timed at the ring phase's block shapes (J and K at each tier), with the
cost of K and M's column atomics logged; and in float64 kernels A and C
on the symmetric DMMA tile, B and D on the rect one and J and K on the
dual one (csrc/gram_dmma.cu, the three tiles' blocks per SM logged)
against their plain versions on ragged shapes at every tier, A and C
timed at 32768 x 512, 49999 x 500 and 59999 x 784 (C = 10), both bounds
and DGEMM beside, B and D at 32768 x 512 beside both bounds and DGEMM, J
and K at the ring's blocks beside both bounds, and every float64 kernel
at the shapes the float64 fits of phases 4, 5 and 13 give it (the ring's
rows-only walks B and D included), A-D, J and K held against their plain
versions there too; and E-H, L and M in float64 (chi-squared on the
divide-free quotient, the timed rows checked to lie within its range on
the host): L and M at the ring's blocks, E-H at the ring's shard shapes
and at its one-device fits' shapes, where E-H are also held per entry of
the chi-squared K against long double, each beside its plain version,
and E-H at m = 8192 and 16384, d = 256, G there also on rows scaled out
of the quotient's range.  Beside every kernel's time it computes the
bound: the least time the card could take for the function on these
inputs (see ``_bound``), and fails if a kernel measures faster than that
(a wrong bound or a wrong timing).  At phases 9 and 10's shapes it holds
kernels E-H in float32 chi-squared per entry of K against the plain
version in float64 (one-hot right-hand sides pick columns of K) and logs
each one's error beside the float32 plain version's and its share of the
bound.  The ring's distance shard products, E-H in float32 and float64,
are timed at the ring's shapes for the cost ranking too.

``python3 chip_smoke.py --compare-build DIR`` also builds the kernels of
another checkout (a parent commit unpacked with ``git archive``) in the
build phase and logs, for every kernel instantiation the two share,
whether its registers, spills and shared memory are the same, and which
instantiations only one of them has; then, right after the kernels
phase, it times float64 E-H, L and M, float32 G at phase 10's shape and
the float64 chi-squared fit on one device and on the ring in both
checkouts, each in a process of its own (other, here, here, other), and
logs the pairs beside the bounds (``phase_compare``).

Before the last line it prints the card's name and power limit as
nvidia-smi reports them, and one JSON object describing each kernel (the
Gram entries with their tier, the tensor-core tile once per tier); the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the repository around it, the script fails and prints no result.
"""

import contextlib
import io
import json
import os
import re
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
#: that; 3.35 TB/s of HBM3; on the tensor cores 495 TFLOP/s TF32 and 989
#: TFLOP/s bf16 (the Gram tiers "f32" and "bf16" of kernels A-D)
FP32_INSTR_PER_S = 67e12 / 2
SFU_OPS_PER_S = FP32_INSTR_PER_S / 8
HBM_BYTES_PER_S = 3.35e12
TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12
#: per tensor-core tier: the product's peak and the operand's bytes per
#: element
TC_TIERS = {"tf32": (TF32_FLOP_PER_S, 4), "bf16": (BF16_FLOP_PER_S, 2)}
#: the Gram tiers of kernels A-D on the tensor cores, by gram_precision
TIER_OF = {"f32": "tf32", "bf16": "bf16"}
#: TF32 and bf16 unit roundoffs (10 and 7 mantissa bits, round to nearest)
UNIT_ROUNDOFF = {"tf32": 2.0 ** -11, "bf16": 2.0 ** -8}
#: the fewest (FP32 instructions, SFU operations) per pair and feature: a
#: Gram product one FFMA; a laplacian term a subtract and an add with |.|;
#: a chi-squared term (x - y)^2 / (x + y) a subtract, an add, a multiply
#: and the multiply by the reciprocal on the FP32 lanes, the reciprocal on
#: the SFU
PAIR_FEATURE_COST = {"gram": (1, 0), "laplacian": (2, 0), "chi_squared": (4, 1)}
#: float64 on the same card (data sheet): 34 TFLOP/s on the FP64 CUDA
#: cores, 17 T DFMA instructions/s, where the FFMA tiles run in float64;
#: 67 TFLOP/s on the FP64 tensor cores (DMMA), where kernels A and C run
FP64_INSTR_PER_S = 34e12 / 2
DMMA_FLOP_PER_S = 67e12
#: the fewest FP64 instructions per pair and feature on the FFMA tiles in
#: float64: a Gram product one DFMA; a laplacian term a subtract and an
#: add with |.|; a chi-squared term two adds, a multiply and the
#: accumulating add, and the quotient's 7: from its reciprocal seed
#: (MUFU.RCP64H, off the FP64 pipe) two Newton steps of 2 DFMAs, the
#: quotient, its residual and the correction, the least an IEEE-rounded
#: float64 quotient takes (gram_tile.cuh ChiSquaredDistance runs exactly
#: that on chunks within its range)
PAIR_FEATURE_COST_F64 = {"gram": 1, "laplacian": 2, "chi_squared": 11}
#: FP64 instructions of one float64 exp (the RBF epilogue on the DMMA
#: tile), at least: the range reduction's quotient (a DFMA), its rounding
#: (a DADD), the two DFMAs of the Cody-Waite remainder and a degree-11
#: polynomial (11 DFMAs); the scaling by 2^j is integer work
EXP_F64_OPS = 15


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


#: run in another checkout: build its kernels, print their resources
_OTHER_BUILD = (
    "import json; from plssvm_tpu_torch.ops import _build; _build.build(); "
    "print(json.dumps(_build.kernel_resources()))"
)


def phase_build(compare=None):
    """Build the kernels and log each instantiation's resources; with
    ``compare`` (another checkout's root) build that one's too, in a
    process of its own, and log which shared instantiations differ."""
    from plssvm_tpu_torch.ops import _build

    path, seconds = _build.build()
    _build.load()
    log("build", f"{path.name} in {seconds:.2f} s"
        + (" (nvcc ran, one process per source)" if seconds > 0
           else " (already built)"))
    mine = _build.kernel_resources()
    for name, res in sorted(mine.items()):
        log("build", f"{name}: {res.get('registers')} registers, "
            f"{res.get('spill_bytes')} spill bytes, "
            f"{res.get('smem_bytes')} B static shared memory")
    # the DMMA tiles, symmetric, dual and rect: one instantiation per Gram
    # kind, compiled once (one source holds them and their entry points), at
    # most 255 registers and spills no larger than the TF32 sym tile's 64
    # bytes; no tensor-core product serialised
    ptxas = _build._ptxas_log(path).read_text(encoding="utf-8")
    for tile in ("gram_dmma_sym", "gram_dmma_dual", "gram_dmma_rect"):
        dmma = {n: r for n, r in mine.items() if n.startswith(tile + " ")}
        compiled = len(re.findall(rf"Compiling entry function '\w*{tile}_kernel", ptxas))
        if (len(dmma) != 3 or compiled != 3
                or any(r.get("spill_bytes", 0) > 64 or r.get("registers", 256) > 255
                       for r in dmma.values())):
            raise AssertionError(f"{tile}'s instantiations ({compiled} compiled): {dmma}")
        log("build", f"{tile}_kernel compiled {compiled} times: " + ", ".join(
            f"{n.split()[-1]} {r['registers']} registers, {r['spill_bytes']} spill bytes, "
            f"{r['smem_bytes']} B static shared memory" for n, r in sorted(dmma.items())))
    if "C7515" in ptxas:
        raise AssertionError("ptxas serialised a tensor-core product (C7515)")
    if compare is not None:
        other = subprocess.run([sys.executable, "-c", _OTHER_BUILD], cwd=compare,
                               capture_output=True, text=True, timeout=900)
        if other.returncode != 0:
            raise AssertionError(f"the build in {compare} failed:\n{other.stderr[-2000:]}")
        theirs = json.loads(other.stdout.strip().splitlines()[-1])
        shared = sorted(set(mine) & set(theirs))
        differ = [n for n in shared if mine[n] != theirs[n]]
        log("build", f"against {compare}: {len(shared)} shared instantiations, "
            f"{len(shared) - len(differ)} with the same resources; differ: "
            + (", ".join(f"{n} {theirs[n]} -> {mine[n]}" for n in differ) or "none")
            + f"; added here: {', '.join(sorted(set(mine) - set(theirs))) or 'none'}; "
            f"removed here: {', '.join(sorted(set(theirs) - set(mine))) or 'none'}")


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


def _tier_plain(plain, precision):
    """The plain version ``plain(*operands, *norms_and_rhs, **kw)`` (X, or P
    and S, before the first vector) on a tier's exact operands:
    TF32-rounded float32 operands with the float32 operands' norms for
    "f32" (the tensor-core tiles' oracle), bf16-rounded operands for "bf16",
    the operands themselves for "highest" and float64."""
    from plssvm_tpu_torch.ops import matvec

    def oracle(*args, **kw):
        if precision == "f32" and args[0].dtype == torch.float32:
            n = next(i for i, a in enumerate(args) if a.ndim == 1)
            args = [matvec.round_to_tf32(a) if i < n else a for i, a in enumerate(args)]
        return plain(*args, precision=precision, **kw)

    return oracle


def _pairs(v, precision="highest"):
    """(name, kernel, plain) of the symmetric and the rectangular kernel for
    a right-hand side v (m,) (kernels A, B) or V (m, C) (kernels C, D) at
    the Gram tier ``precision``.  At "f32" and "bf16" both kernels on
    float32 are the tensor-core tiles (``*_sym_tc``, ``*_rect_tc``), held
    against the plain version on the tier's operands; at "highest" the
    FFMA tile; in float64 both are DMMA tiles (``*_sym_dmma``,
    ``*_rect_dmma``)."""
    import functools

    from plssvm_tpu_torch.ops import gram_matmat, gram_matvec, matvec

    if v.ndim == 2:
        base, sym, sym_plain, rect, rect_plain = (
            "gram_matmat", gram_matmat.gram_matmat_sym, matvec.kernel_matmat_plain,
            gram_matmat.gram_matmat_rect, matvec.kernel_matmat_rect_plain)
    else:
        base, sym, sym_plain, rect, rect_plain = (
            "gram_matvec", gram_matvec.gram_matvec_sym, matvec.kernel_matvec_plain,
            gram_matvec.gram_matvec_rect, matvec.kernel_matvec_rect_plain)
    tc = "_tc" if precision != "highest" and v.dtype == torch.float32 else ""
    tile = "_dmma" if v.dtype == torch.float64 else tc
    return (
        (f"{base}_sym{tile}", functools.partial(sym, precision=precision),
         _tier_plain(sym_plain, precision)),
        (f"{base}_rect{tile}", functools.partial(rect, precision=precision),
         _tier_plain(rect_plain, precision)),
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


def _compare(kind, coef0, X, P, v, precision="highest", rect=True):
    """max|kernel - plain| and max|plain| for kernels A and B (v (m,)) or
    C and D (v (m, C)) at the Gram tier ``precision`` (``_pairs``); the
    rectangular kernel only when ``rect``."""
    kw = dict(kind=kind, gamma=1.0 / X.shape[1], coef0=coef0, degree=3)
    sq, sq_p = (X * X).sum(-1), (P * P).sum(-1)
    (sym_name, sym, sym_plain), (rect_name, rect_k, rect_plain) = _pairs(v, precision)
    out = {}
    cases = [(sym_name, sym, sym_plain, (X, sq, v))]
    if rect:
        cases.append((rect_name, rect_k, rect_plain, (P, X, sq_p, sq, v)))
    for name, kernel, plain, args in cases:
        out[name] = _check_close(
            f"{name} {kind} {X.dtype} {precision} {tuple(X.shape)}",
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


#: the ring phase's shards, all on device 0
RING_SHARDS = 4
#: the ring phase's float64 fits stop at epsilon 1e-10, where one-device
#: and ring solves are both converged: at a cell's own epsilon they may
#: stop an iteration apart (chi-squared at 1e-7 on an H100: 31 against 32
#: iterations, decision values 5.5e-3 apart)
RING_F64_EPSILON = 1e-10
def _dual_pair(name, precision):
    """(kernel, plain) of a dual kernel (J-M, by wrapper name), both taking
    (Xr, Xc, [sq_r, sq_c,] V_c, V_r, **kw); the plain version on the tier's
    operands (TF32-rounded float32 Xr and Xc at "f32", as the tensor-core
    tile gets them)."""
    from plssvm_tpu_torch.ops import distance, gram_matmat, gram_matvec, matvec

    module = {"gram_matvec_dual": gram_matvec, "gram_matmat_dual": gram_matmat}.get(
        name, distance)
    kernel = getattr(module, name)
    plain = getattr(matvec, name.replace("gram", "kernel") + "_plain")
    if name.startswith("distance"):
        return kernel, plain

    def oracle(Xr, Xc, *rest, **kw):
        if precision == "f32" and Xr.dtype == torch.float32:
            Xr, Xc = matvec.round_to_tf32(Xr), matvec.round_to_tf32(Xc)
        return plain(Xr, Xc, *rest, precision=precision, **kw)

    return (lambda *args, **kw: kernel(*args, precision=precision, **kw)), oracle


def _check_dual(label, got, want):
    """Both outputs of a dual kernel against the plain version's; returns
    the larger (max|err|, max|plain|) pair's relative error and max|err|."""
    errs = [_check_close(f"{label} {half}", g, w)
            for half, g, w in zip(("out_r", "out_c"), got, want)]
    return max(e / max(sc, 1e-300) for e, sc in errs), max(e for e, _ in errs)


def _dual_per_entry(X, gamma, label):
    """Kernels L and M in float32 chi-squared, per entry of K: both outputs
    (out_r = K(Xr, Xc) @ V_c and out_c = K(Xr, Xc)^T @ V_r) with one-hot
    right-hand sides, each entry against the plain version in float64
    (``entry_errors``), raised past 4x the float32 plain version's error or
    1e-4.  Xr is the first half of X, Xc the second."""
    from plssvm_tpu_torch.ops import distance
    from plssvm_tpu_torch.ops.entry_check import entry_errors

    half = X.shape[0] // 2
    Xr, Xc = X[:half].contiguous(), X[half:].contiguous()
    columns = [int(j) for j in np.linspace(0, Xc.shape[0] - 1, MC_CLASSES)]
    for name, fn in (("distance_matvec_dual", distance.distance_matvec_dual),
                     ("distance_matmat_dual", distance.distance_matmat_dual)):
        one = name == "distance_matvec_dual"

        def zeros(rows, V):
            return torch.zeros((rows,) + V.shape[1:], device="cuda")

        for out, kernel in (
            # K(P, S) @ V as the rows output of the walk over (P, S) ...
            ("out_r", lambda P, S, V, **kw: fn(P, S, V, zeros(P.shape[0], V), **kw)[0]),
            # ... and as the columns output of the walk over (S, P)
            ("out_c", lambda P, S, V, **kw: fn(S, P, zeros(P.shape[0], V), V, **kw)[1]),
        ):
            got, plain = entry_errors(kernel, Xc, columns, gamma, points=Xr, one_column=one)
            if not got <= min(4 * plain, 1e-4):
                raise AssertionError(f"{name} {out} chi-squared {label}: per-entry error "
                                     f"{got}, plain f32 {plain}")
            log("kernels", f"per-entry {name} {out} f32 chi-squared {label}, {MC_CLASSES} "
                f"columns of K: worst rel err {got:.3e}, plain f32 {plain:.3e} "
                f"({got / plain:.2f}x)")


def _dual_counter(name, dtype, precision):
    """(module, counter) that a launch of dual kernel ``name`` at the tier
    adds to: J and K on float32 at "f32" / "bf16" the tensor-core tile's
    ``dual_tc_launches``, at "highest" the FFMA tile's, in float64 at every
    tier the dual DMMA tile's ``dual_dmma_launches``."""
    from plssvm_tpu_torch.ops import distance, gram_matmat, gram_matvec

    if name.startswith("distance"):
        return distance, name.split("_", 1)[1].replace("dual", "dual_launches")
    module = gram_matvec if name == "gram_matvec_dual" else gram_matmat
    if dtype == torch.float64:
        return module, "dual_dmma_launches"
    return module, "dual_tc_launches" if precision in TIER_OF else "dual_launches"


def _dual_blocks_per_sm():
    """The dual tensor-core tile's blocks per SM for every tier and Gram
    kind, logged; raises below the two its design needs."""
    import ctypes

    from plssvm_tpu_torch.ops import _build

    lib = _build.load()
    found = {}
    for tier, bf16 in (("tf32", 0), ("bf16", 1)):
        for kind, name in ((1, "poly"), (2, "rbf"), (3, "sigmoid")):
            blocks = ctypes.c_int(0)
            err = lib.plssvm_gram_dual_tc_blocks_per_sm(bf16, kind, ctypes.byref(blocks))
            if err != 0:
                raise AssertionError(f"gram_tc_dual {tier} {name}: occupancy query failed "
                                     f"({lib.plssvm_cuda_error_string(err).decode()})")
            found[f"{tier} {name}"] = blocks.value
    log("kernels", "gram_tc_dual blocks per SM: " + ", ".join(
        f"{k} {v}" for k, v in found.items()))
    if min(found.values()) < 2:
        raise AssertionError(f"the dual tensor-core tile fits fewer than 2 blocks an SM: {found}")


def _dual_kernels(gen, main_err, main_ms, timing, bounds):
    """Kernels J-M (the ring's dual walks: csrc/dual.cu, J and K on the
    dual tensor-core tile of csrc/gram_tc.cuh at "f32" and "bf16" and on
    the dual DMMA tile of csrc/gram_dmma.cu in float64) against their plain
    versions, both outputs, on ragged mr != mc blocks, float32 and float64,
    J and K at each Gram tier, each launch on the tile its tier and type
    name; L and M per entry of K in float32 chi-squared; then each
    timed at the ring phase's block shape beside its plain version and its
    bound, recorded under (name, tier or kind), J and K at "f32" (the ring
    phase's tier) with "bf16" and the FFMA tile's "highest" logged
    beside."""
    from plssvm_tpu_torch.parameter import KernelFunctionType as K

    _dual_blocks_per_sm()
    kinds = ((K.POLYNOMIAL, 1.0), (K.RBF, 0.0), (K.SIGMOID, -0.5), (K.LAPLACIAN, 0.0),
             (K.CHI_SQUARED, 0.0))
    worst = {}
    for dtype in (torch.float32, torch.float64):
        # the last two: more column tiles than a run takes (kTcMaxRun = 8),
        # and runs of 2 with a short last one on the tensor-core tile
        for mr, mc, d in ((1037, 513, 203), (300, 777, 1280), (129, 65, 3), (1, 1, 5),
                          (130, 1100, 13), (2100, 17000, 37)):
            for n_classes in (None, 1, 10, 37):
                Xr, Xc = _zero_rich(mr, d, dtype, gen), _zero_rich(mc, d, dtype, gen)
                sq_r, sq_c = (Xr * Xr).sum(-1), (Xc * Xc).sum(-1)
                tail = () if n_classes is None else (n_classes,)
                v_c = torch.randn(mc, *tail, generator=gen, dtype=torch.float64).to("cuda", dtype)
                v_r = torch.randn(mr, *tail, generator=gen, dtype=torch.float64).to("cuda", dtype)
                for kind, coef0 in kinds:
                    distance_kind = kind in (K.LAPLACIAN, K.CHI_SQUARED)
                    name = (("distance" if distance_kind else "gram")
                            + ("_matvec_dual" if n_classes is None else "_matmat_dual"))
                    for precision in (("highest",) if distance_kind
                                      else ("highest", "f32", "bf16")):
                        kernel, plain = _dual_pair(name, precision)
                        if distance_kind:
                            args, kw = (Xr, Xc, v_c, v_r), dict(kind=kind, gamma=1.0 / d)
                        else:
                            args = (Xr, Xc, sq_r, sq_c, v_c, v_r)
                            kw = dict(kind=kind, gamma=1.0 / d, coef0=coef0, degree=3)
                        label = f"{name} {kind} {dtype} {precision} {mr}x{mc}x{d} C={n_classes}"
                        module, counter = _dual_counter(name, dtype, precision)
                        before = getattr(module, counter)
                        got = kernel(*args, **kw)
                        if getattr(module, counter) != before + 1:
                            raise AssertionError(f"{label}: not launched on {counter}")
                        rel, _ = _check_dual(label, got, plain(*args, **kw))
                        key = (name, str(dtype).split(".")[-1], precision)
                        worst[key] = max(worst.get(key, 0.0), rel)
    for (name, dt, precision), rel in sorted(worst.items()):
        log("kernels", f"{name} {dt} {precision}: worst max|err|/max|plain| {rel:.3e}, both "
            "outputs, over 6 ragged mr != mc blocks x 1-37 classes"
            + (" x laplacian/chi-squared" if name.startswith("distance")
               else " x poly/rbf/sigmoid (plain on the tier's operands)"))

    # the ring phase's blocks (4 shards): config 3's width, 12500 x 12500 x
    # 500 RBF (J); MNIST's, 15000 x 15000 x 784, 10 classes (K); config 2's,
    # 2500 x 2500 x 200, laplacian (L) and chi-squared on histogram rows, 10
    # classes (M); J and K at the default tier "f32" (TF32 operands)
    rng = np.random.default_rng(SEED + 20)
    hist = torch.as_tensor(_draw_histograms(rng, _histogram_classes(rng, 200), 5000)[0],
                           dtype=torch.float32, device="cuda")
    chi2_gamma = _chi2_gamma(rng, hist.cpu().numpy().astype(np.float64))
    _dual_per_entry(hist, chi2_gamma, "2500x2500x200")
    cases = []
    for name, mr, d, n_classes, kind, tier in (
        ("gram_matvec_dual", 12500, 500, None, K.RBF, "f32"),
        ("gram_matmat_dual", 15000, 784, MC_CLASSES, K.RBF, "f32"),
        ("distance_matvec_dual", 2500, 200, None, K.LAPLACIAN, None),
        ("distance_matmat_dual", 2500, 200, MC_CLASSES, K.CHI_SQUARED, None),
    ):
        tail = () if n_classes is None else (n_classes,)
        v_c = torch.randn(mr, *tail, generator=gen, dtype=torch.float64).to("cuda", torch.float32)
        v_r = torch.randn(mr, *tail, generator=gen, dtype=torch.float64).to("cuda", torch.float32)
        if kind == K.CHI_SQUARED:
            Xr, Xc = hist[:mr].contiguous(), hist[mr:2 * mr].contiguous()
            args, kw, gamma = (Xr, Xc, v_c, v_r), dict(kind=kind, gamma=chi2_gamma), None
        else:
            X = torch.randn(2 * mr, d, generator=gen, dtype=torch.float64).to("cuda", torch.float32)
            if d == 500:
                X = X / X.abs().amax(0)  # config 3's [-1, 1] scale
            Xr, Xc = X[:mr].contiguous(), X[mr:].contiguous()
            if kind == K.LAPLACIAN:
                args, kw = (Xr, Xc, v_c, v_r), dict(kind=kind, gamma=1.0 / d)
            else:
                args = (Xr, Xc, (Xr * Xr).sum(-1), (Xc * Xc).sum(-1), v_c, v_r)
                kw = dict(kind=kind, gamma=1.0 / d, coef0=0.0, degree=3)
        cases.append((name, args, kw, tier, n_classes, kind))
    for name, args, kw, tier, n_classes, kind in cases:
        kernel, plain = _dual_pair(name, tier or "highest")
        mr, d = args[0].shape
        columns = n_classes or 1
        base = f"{mr}x{mr}x{d} f32 {kind}" + (f" C={columns}" if n_classes else "")
        label = base + (f" {tier}" if tier else "")
        key = (name, TIER_OF[tier]) if tier else (name, str(kind))
        main_err[key] = _check_dual(label, kernel(*args, **kw), plain(*args, **kw))[1]
        cost = "gram" if tier else str(kind)
        timing[key] = _time_pair(name, kernel, plain, args, kw, float(mr) * mr * d, label,
                                 plain_repeats=20 if tier else DIST_PLAIN_REPEATS,
                                 unit="Tpair-feature/s", counted="mr mc d")
        # J and K at "f32" compute the TF32 function, which the tensor cores
        # could compute: their bound is the TF32 one; the FFMA tile's own
        # bound is logged beside it
        bounds[key] = _dual_bound(mr, mr, d, columns, cost, 4, 1 if tier else 0,
                                  TIER_OF.get(tier), exp=kind == K.RBF)
        main_ms[(name, "ring")] = (timing[key][0], bounds[key][0])
        _log_bound(name, label, timing[key][0], bounds[key])
        if tier:
            _time_dual_tiers(name, args, kw, mr, d, columns, base, timing[key][0])
    lap = torch.randn(5000, 200, generator=gen, dtype=torch.float64).to("cuda", torch.float32)
    _ring_distance_shards(gen, main_err, main_ms, lap, hist, chi2_gamma, "ring")

    # the atomics of the column sums: K and M issue one per column, class
    # and tile where the rectangular D and H (same tile, row sums only)
    # issue none for columns; each at 10 classes against 1 class on the
    # same block, the dual walk beside the rectangular one, K on the FFMA
    # tile ("highest") and on the tensor-core tiles ("f32")
    from plssvm_tpu_torch.ops import distance, gram_matmat

    for name, args, kw, tier, n_classes, kind in cases:
        if not n_classes:
            continue
        Xr, Xc = args[0], args[1]
        for precision in (("highest", "f32") if tier else ("highest",)):
            rhs = {}
            for c in (1, MC_CLASSES):
                v_c, v_r = args[-2][:, :c].contiguous(), args[-1][:, :c].contiguous()
                if name == "gram_matmat_dual":
                    sq = args[2:4]
                    walks = (
                        (gram_matmat.gram_matmat_dual, (Xr, Xc, *sq, v_c, v_r)),
                        (gram_matmat.gram_matmat_rect, (Xr, Xc, *sq, v_c)),
                    )
                    walk_kw = dict(kw, precision=precision)
                else:
                    walks = ((distance.distance_matmat_dual, (Xr, Xc, v_c, v_r)),
                             (distance.distance_matmat_rect, (Xr, Xc, v_c)))
                    walk_kw = kw
                rhs[c] = [_median_ms(lambda: fn(*fn_args, **walk_kw), 5, 1)
                          for fn, fn_args in walks]
            (d1, r1), (d10, r10) = rhs[1], rhs[MC_CLASSES]
            log("kernels", f"column atomics {name} {tuple(Xr.shape)} {precision}: dual walk "
                f"C=1 {d1:.3f} ms, C={MC_CLASSES} {d10:.3f} ms (+{d10 - d1:.3f}); "
                f"rectangular (rows only) C=1 {r1:.3f}, C={MC_CLASSES} {r10:.3f} "
                f"(+{r10 - r1:.3f}); the classes' cost "
                f"{(d10 - d1) / max(r10 - r1, 1e-9):.2f}x the rows-only one's, "
                f"{(d10 - d1) / d10:.1%} of the dual walk at C={MC_CLASSES}")


def _ring_distance_shards(gen, main_err, main_ms, lap, hist, chi2_gamma, phase):
    """The ring's distance shard products beside its dual walks, at the
    ring phase's shard shape (four shards of 10000 rows): per shard and
    product the symmetric E (laplacian, on ``lap``'s rows) or G
    (chi-squared on the histogram rows ``hist``, C = 10) at 2500 x 200,
    and the rows-only walk F or H of the antipodal pair at 2500^2 x 200;
    each against its plain version, then timed beside its bound and
    recorded under (name, ``phase``), with "_f64" after the name in
    float64."""
    from plssvm_tpu_torch.parameter import KernelFunctionType as K

    suffix = "_f64" if hist.dtype == torch.float64 else ""
    itemsize = hist.element_size()
    for kind, X, gamma, n_classes in ((K.LAPLACIAN, lap, 1.0 / 200, None),
                                      (K.CHI_SQUARED, hist, chi2_gamma, MC_CLASSES)):
        Xr, Xc = X[:2500].contiguous(), X[2500:5000].contiguous()
        tail = () if n_classes is None else (n_classes,)
        v = torch.randn(2500, *tail, generator=gen, dtype=torch.float64).to("cuda", X.dtype)
        kw = dict(kind=kind, gamma=gamma)
        columns = n_classes or 1
        (sym, sym_k, sym_plain), (rect, rect_k, rect_plain) = _distance_pairs(v)
        dtype = str(X.dtype).split(".")[-1]
        for name, kernel, plain, args, bound, label in (
            (sym, sym_k, sym_plain, (Xr, v),
             _sym_bound(2500, 200, columns, str(kind), itemsize, 0, "fp64" if suffix else None),
             f"2500x200 {dtype} {kind} C={columns} (a shard)"),
            (rect, rect_k, rect_plain, (Xr, Xc, v),
             _rect_bound(2500, 2500, 200, columns, str(kind), itemsize, 0,
                         "fp64" if suffix else None),
             f"2500x2500x200 {dtype} {kind} C={columns} (the rows-only walk)"),
        ):
            err = _check_close(f"{name} {label}", kernel(*args, **kw), plain(*args, **kw))[0]
            key = (name, "f64" if suffix else str(kind))
            main_err[key] = max(main_err.get(key, 0.0), err)
            _time_at_main_shape(main_ms, name + suffix, phase, lambda: kernel(*args, **kw),
                                bound, label)


def _time_dual_tiers(name, args, kw, mr, d, columns, label, tf32_ms):
    """J or K at a ring block (``label`` its shape) beside its "f32" time
    ``tf32_ms``: at "bf16" on the tensor-core tile against the plain version
    at "bf16" and the bf16 bound, and on the FFMA tile ("highest") against
    its own bound; logged only, the ring phase runs "f32"."""
    exp = str(kw["kind"]) == "rbf"
    kernel, plain = _dual_pair(name, "bf16")
    bf16_ms = _time_pair(name, kernel, plain, args, kw, float(mr) * mr * d, f"{label} bf16",
                         unit="Tpair-feature/s", counted="mr mc d")[0]
    _log_bound(name, f"{label} bf16", bf16_ms,
               _dual_bound(mr, mr, d, columns, "gram", 4, 1, "bf16", exp=exp))
    kernel, _ = _dual_pair(name, "highest")
    ffma_ms = _median_ms(lambda: kernel(*args, **kw), 5, 1)
    ffma = _dual_bound(mr, mr, d, columns, "gram", 4, 1)
    _log_bound(name, f"{label} highest (the FFMA tile)", ffma_ms, ffma)
    log("kernels", f"{name} {mr}x{mr}x{d}: the tensor-core tile at f32 (TF32) "
        f"{tf32_ms:.3f} ms, at bf16 {bf16_ms:.3f} ms; the FFMA tile at highest "
        f"{ffma_ms:.3f} ms ({ffma_ms / tf32_ms:.2f}x the TF32 time)")


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


def _bound(pairs, d, fmas, cost, n_bytes, tier=None, exp_pairs=0):
    """(ms, "operations" or "bytes"): the least time the card could take
    for a function that evaluates ``pairs`` kernel values over ``d``
    features, contracts them in ``fmas`` FFMAs (DFMAs in float64), and
    moves ``n_bytes`` (each input read once, each output written once) --
    the larger of the operations over their peak rate and the bytes over
    the memory rate.

    On the FFMA tile (``tier`` None, float32; "fp64", float64) a pair and
    feature costs ``PAIR_FEATURE_COST[cost]`` (FP32 and SFU instructions)
    or ``PAIR_FEATURE_COST_F64[cost]`` (FP64 instructions) and the per-pair
    epilogue (one exp or power, 1/d of the pair work) is not counted.  On
    the tensor cores (``tier`` "tf32" or "bf16") the pair work is 2 pairs d
    flops at the tier's peak, beside which the FP32 lanes run the
    contraction's FFMAs and the SFU one exp per pair for ``exp_pairs``
    pairs (RBF): the bound is the largest of the three, as the units run
    side by side.  On the FP64 tensor cores (``tier`` "dmma", float64) the
    pair work is 2 pairs d flops at 67 TFLOP/s, beside which the FP64 pipe
    runs the contraction's DFMAs and ``EXP_F64_OPS`` per exp."""
    if tier is None:
        fp32, sfu = PAIR_FEATURE_COST[cost]
        ops_s = max((fp32 * pairs * d + fmas) / FP32_INSTR_PER_S,
                    sfu * pairs * d / SFU_OPS_PER_S)
    elif tier == "fp64":
        ops_s = (PAIR_FEATURE_COST_F64[cost] * pairs * d + fmas) / FP64_INSTR_PER_S
    elif tier == "dmma":
        ops_s = max(2.0 * pairs * d / DMMA_FLOP_PER_S,
                    (fmas + EXP_F64_OPS * exp_pairs) / FP64_INSTR_PER_S)
    else:
        ops_s = max(2.0 * pairs * d / TC_TIERS[tier][0], fmas / FP32_INSTR_PER_S,
                    exp_pairs / SFU_OPS_PER_S)
    bytes_s = n_bytes / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


def _sym_bound(m, d, columns, cost, itemsize, extra_inputs=0, tier=None,
               exp=False):
    """The bound of ``K(X, X) @ V`` for X (m, d) and V (m, columns): the
    m (m + 1) / 2 distinct pairs of a symmetric kernel, m^2 FFMAs per
    column; X, V, the output and ``extra_inputs`` vectors of m moved.  On
    the tensor cores (``tier``) X moves at the tier's operand size and the
    rest at float32; ``exp`` counts one SFU exp per pair.  ``tier`` "fp64"
    and "dmma" are float64 (``itemsize`` 8) on the FFMA and the DMMA tile."""
    pairs = m * (m + 1) / 2
    if tier not in TC_TIERS:
        n_bytes = itemsize * m * (d + 2 * columns + extra_inputs)
    else:
        n_bytes = TC_TIERS[tier][1] * m * d + 4 * m * (2 * columns + extra_inputs)
    return _bound(pairs, d, float(m) * m * columns, cost, n_bytes, tier,
                  pairs if exp else 0)


def _rect_bound(n_p, n_s, d, columns, cost, itemsize, extra_inputs=0,
                tier=None, exp=False):
    """The bound of ``K(P, S) @ A`` for P (n_p, d), S (n_s, d) and A (n_s,
    columns): every pair, n_p n_s FFMAs per column; P, S, A, the output and
    ``extra_inputs`` vectors of n_p and of n_s moved.  On the tensor cores
    (``tier``) P and S move at the tier's operand size and the rest at
    float32; ``exp`` counts one SFU exp per pair; ``tier`` "fp64" is the
    FFMA tile in float64 and "dmma" the rect DMMA tile (``itemsize`` 8
    both; ``exp`` one float64 exp a pair on the FP64 pipe)."""
    pairs = float(n_p) * n_s
    if tier not in TC_TIERS:
        n_bytes = itemsize * ((n_p + n_s) * (d + extra_inputs) + (n_s + n_p) * columns)
    else:
        n_bytes = (TC_TIERS[tier][1] * (n_p + n_s) * d
                   + 4 * (n_p + n_s) * (extra_inputs + columns))
    return _bound(pairs, d, pairs * columns, cost, n_bytes, tier,
                  pairs if exp else 0)


def _dual_bound(mr, mc, d, columns, cost, itemsize, extra_inputs=0, tier=None,
                exp=False):
    """The bound of the dual walk ``(K @ V_c, K^T @ V_r)`` of ``K = K(Xr,
    Xc)`` for Xr (mr, d), Xc (mc, d), V_c (mc, columns), V_r (mr, columns):
    every one of the mr mc pairs, 2 mr mc FFMAs per column (both
    contractions); Xr, Xc, both right-hand sides, both outputs and
    ``extra_inputs`` vectors of mr and of mc moved.  ``tier`` and ``exp``
    as in ``_rect_bound``: on the tensor cores the same function (TF32 or
    bf16 products, float32 sums) could run at the tier's peak; ``tier``
    "fp64" is the FFMA walk in float64 and "dmma" the dual DMMA tile
    (``itemsize`` 8 both; ``exp`` one float64 exp a pair on the FP64
    pipe)."""
    pairs = float(mr) * mc
    if tier not in TC_TIERS:
        n_bytes = itemsize * (mr + mc) * (d + 2 * columns + extra_inputs)
    else:
        n_bytes = (TC_TIERS[tier][1] * (mr + mc) * d
                   + 4 * (mr + mc) * (2 * columns + extra_inputs))
    return _bound(pairs, d, 2.0 * pairs * columns, cost, n_bytes, tier,
                  pairs if exp else 0)


def _check_tf32_tier(label, got, want, gamma, spread):
    """A tensor-core kernel at "f32" (TF32) against the full-float32 plain
    version: max|err| within 4 u gamma max|x|^2 of max|plain|, the
    first-order bound of an RBF entry's relative error when both operands
    round to TF32 (u = 2^-11; |dK/K| = 2 gamma |dg| <= 4 u gamma |x_i|
    |x_j|), ``spread`` = max|x|^2 over both operands.  Logs it, raises past
    it; returns max|err| / max|plain|."""
    torch.cuda.synchronize()
    rel = float((got - want).abs().max()) / float(want.abs().max())
    limit = 4 * UNIT_ROUNDOFF["tf32"] * gamma * spread
    log("kernels", f"{label} f32 (TF32) against full float32: max|err|/max|plain| "
        f"{rel:.3e}, first-order limit {limit:.3e}")
    if not (torch.isfinite(got).all() and rel <= limit):
        raise AssertionError(f"{label}: TF32 error {rel} past {limit}")
    return rel


def _check_share(name, label, k_ms, b_ms):
    """A kernel measured faster than its bound means a wrong bound or a
    wrong timing, never a fast kernel: raise."""
    if not k_ms >= b_ms:
        raise AssertionError(f"{name} {label}: {k_ms:.3f} ms is under its bound "
                             f"{b_ms:.3f} ms, a share of {b_ms / k_ms:.3f}")


def _log_bound(name, label, k_ms, bound):
    b_ms, by = bound
    _check_share(name, label, k_ms, b_ms)
    log("kernels", f"{name} {label}: kernel {k_ms:.3f} ms, bound {b_ms:.3f} ms ({by}), "
        f"{b_ms / k_ms:.3f} of it")


def _time_at_main_shape(main_ms, name, phase, fn, bound, label):
    """A kernel's median ms (5 after 1 warm-up) at the shape a main-path
    phase gives it, beside its bound there; recorded for the cost ranking
    that ``main`` prints under ``(name, phase)``, or only logged when
    ``phase`` is None.  Returns the ms."""
    ms = _median_ms(fn, 5, 1)
    _check_share(name, f"at {phase or 'a main path'}'s shape {label}", ms, bound[0])
    if phase is not None:
        main_ms[(name, phase)] = (ms, bound[0])
    log("kernels", f"{name} at {'phase ' + phase if phase else 'a main path'}'s "
        f"shape {label}: {ms:.3f} ms, bound {bound[0]:.3f} ms ({bound[1]}), "
        f"{bound[0] / ms:.3f} of it")
    return ms


def _log_operand_time(X, label):
    """The tensor-core tile's operand copies of X (``tier_operand``), made
    once per solve: their ms (median of 5 after 1 warm-up)."""
    from plssvm_tpu_torch.ops import gram_matvec

    times = {tier: _median_ms(lambda: gram_matvec.tier_operand(X, tier), 5, 1)
             for tier in ("f32", "bf16")}
    log("kernels", f"operand copy {label}: f32 (TF32-rounded) {times['f32']:.3f} ms, "
        f"bf16 {times['bf16']:.3f} ms")


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

    def check(X, P, v, tiers):
        for precision in tiers:
            for kind, coef0 in kinds:
                for name, (err, scale) in _compare(kind, coef0, X, P, v, precision).items():
                    key = (name, str(X.dtype).split(".")[-1], precision)
                    worst[key] = max(worst.get(key, 0.0), err / max(scale, 1e-300))

    for dtype in (torch.float32, torch.float64):
        # the tiers are float32's; in float64, at every tier, A-D take the
        # DMMA tiles (_f64_kernels checks them at every tier)
        tiers = ("highest", "f32", "bf16") if dtype == torch.float32 else ("highest",)
        for m, d in ((1037, 203), (8192, 512), (777, 1280), (129, 3), (65, 37), (1, 5)):
            check(*_operands(m, d, dtype, gen), tiers)
        # kernels C and D: 1 class, a few, and across the 8-class chunk
        for m, d in ((1037, 203), (777, 1280), (129, 3), (1, 5)):
            for n_classes in (1, 3, 10, 37):
                check(*_operands(m, d, dtype, gen, n_classes=n_classes), tiers)
        check(*_operands(8192, 512, dtype, gen, n_classes=10), tiers)
    for (name, dt, precision), rel in sorted(worst.items()):
        log("kernels", f"{name} {dt} {precision}: worst max|err|/max|plain| {rel:.3e} "
            "over poly/rbf/sigmoid x 5 or 6 shapes"
            + (" x 1-37 classes" if "matmat" in name else "")
            + (" (plain on the tier's operands)" if precision != "highest" else ""))

    # the main paths' own shapes, f32: config 2 training (dept = 9999 rows)
    # and predict (2000 points against 10000 SVs), config 3 training; each
    # tier's kernel, recorded for the phase that runs it: "f32" (TF32) in
    # e2e and config3, "bf16" in the bf16 phase; "highest" logged beside
    main_err, main_ms = {}, {}
    X, P, v = _operands(9999, 200, torch.float32, gen, n_points=2000)
    rbf = dict(kind=K.RBF, gamma=1.0 / 200, coef0=0.0, degree=3)
    sq = (X * X).sum(-1)
    main_err["gram_matvec_sym"] = _compare(K.RBF, 0.0, X, P, v, rect=False)["gram_matvec_sym"][0]
    for tier, phase in (("f32", "e2e"), ("bf16", "bf16")):
        key = ("gram_matvec_sym_tc", TIER_OF[tier])
        main_err[key] = _compare(K.RBF, 0.0, X, P, v, tier, rect=False)["gram_matvec_sym_tc"][0]
        _time_at_main_shape(main_ms, "gram_matvec_sym_tc", phase,
                            lambda: gram_matvec.gram_matvec_sym(X, sq, v, precision=tier, **rbf),
                            _sym_bound(9999, 200, 1, "gram", 4, 1, TIER_OF[tier], exp=True),
                            f"9999x200 rbf {tier}")
    _time_at_main_shape(main_ms, "gram_matvec_sym", None,
                        lambda: gram_matvec.gram_matvec_sym(X, sq, v, precision="highest", **rbf),
                        _sym_bound(9999, 200, 1, "gram", 4, 1), "9999x200 rbf highest")
    X, P, v = _operands(10000, 200, torch.float32, gen, n_points=2000)
    sq, sq_p = (X * X).sum(-1), (P * P).sum(-1)
    main_err["gram_matvec_rect"] = _compare(K.RBF, 0.0, X, P, v)["gram_matvec_rect"][0]
    for tier, phase in (("f32", "e2e"), ("bf16", "bf16")):
        key = ("gram_matvec_rect_tc", TIER_OF[tier])
        main_err[key] = _compare(K.RBF, 0.0, X, P, v, tier)["gram_matvec_rect_tc"][0]
        _time_at_main_shape(main_ms, "gram_matvec_rect_tc", phase,
                            lambda: gram_matvec.gram_matvec_rect(P, X, sq_p, sq, v,
                                                                 precision=tier, **rbf),
                            _rect_bound(2000, 10000, 200, 1, "gram", 4, 1, TIER_OF[tier],
                                        exp=True),
                            f"2000x10000x200 rbf {tier}")
    _time_at_main_shape(main_ms, "gram_matvec_rect", None,
                        lambda: gram_matvec.gram_matvec_rect(P, X, sq_p, sq, v,
                                                             precision="highest", **rbf),
                        _rect_bound(2000, 10000, 200, 1, "gram", 4, 1),
                        "2000x10000x200 rbf highest")
    _check_tf32_tier("gram_matvec_rect_tc 2000x10000x200 rbf",
                     gram_matvec.gram_matvec_rect(P, X, sq_p, sq, v, precision="f32", **rbf),
                     matvec.kernel_matvec_rect_plain(P, X, sq_p, sq, v, **rbf),
                     rbf["gamma"], float(torch.maximum(sq.max(), sq_p.max())))
    X, P, v = _operands(49999, 500, torch.float32, gen, n_points=1)
    X = X / X.abs().amax(0)  # the [-1, 1] scale of config 3
    P = P / P.abs().amax(0)
    sq = (X * X).sum(-1)
    poly = dict(kind=K.POLYNOMIAL, gamma=1.0 / 500, coef0=0.0, degree=3)
    cfg3 = {}
    for tier in ("f32", "bf16", "highest"):
        cfg3[tier] = _compare(K.POLYNOMIAL, 0.0, X, P, v, tier, rect=False)
        tc = tier != "highest"
        _time_at_main_shape(
            main_ms, "gram_matvec_sym_tc" if tc else "gram_matvec_sym",
            "config3" if tier == "f32" else None,
            lambda: gram_matvec.gram_matvec_sym(X, sq, v, precision=tier, **poly),
            _sym_bound(49999, 500, 1, "gram", 4, 1, TIER_OF.get(tier)),
            f"49999x500 poly {tier}")
    _log_operand_time(X, "49999x500")
    log("kernels", "main-path shapes f32: sym 9999x200 rbf max|err| "
        f"{main_err['gram_matvec_sym']:.3e} (highest), "
        f"{main_err[('gram_matvec_sym_tc', 'tf32')]:.3e} (f32), "
        f"{main_err[('gram_matvec_sym_tc', 'bf16')]:.3e} (bf16); rect 2000x10000x200 "
        f"rbf {main_err['gram_matvec_rect']:.3e} (highest), "
        f"{main_err[('gram_matvec_rect_tc', 'tf32')]:.3e} (f32), "
        f"{main_err[('gram_matvec_rect_tc', 'bf16')]:.3e} (bf16); sym 49999x500 poly "
        + ", ".join(f"{next(iter(c.values()))[0]:.3e} ({t})" for t, c in cfg3.items())
        + f" (max|plain| {next(iter(cfg3['highest'].values()))[1]:.3e})")
    # the multiclass paths' shapes, 10 classes: phase 5 training (9999
    # rows) and predict (2000 points against 10000 SVs), phase 7 training
    # (59999 x 784) and predict (10000 points against 60000 SVs)
    for (m, d, n_points) in ((9999, 200, 2000), (59999, 784, 10000)):
        X, P, V = _operands(m, d, torch.float32, gen, n_points=n_points,
                            n_classes=MC_CLASSES)
        phase = "multiclass" if m < 10000 else "mnist-width"
        rbf = dict(kind=K.RBF, gamma=1.0 / d, coef0=0.0, degree=3)
        sq, sq_p = (X * X).sum(-1), (P * P).sum(-1)
        S, A = torch.cat([X, X[:1]]), torch.cat([V, V[:1]])  # the model keeps all m + 1 points
        sq_s = (S * S).sum(-1)
        errs = {}
        for tier in ("f32", "bf16", "highest"):
            name, key = (("gram_matmat_sym_tc", ("gram_matmat_sym_tc", TIER_OF[tier]))
                         if tier != "highest" else ("gram_matmat_sym", "gram_matmat_sym"))
            errs[tier] = _compare(K.RBF, 0.0, X, P, V, tier, rect=False)[name]
            if tier != "bf16" or phase == "multiclass":
                main_err[key] = max(main_err.get(key, 0.0), errs[tier][0])
            record = {"f32": phase, "bf16": "bf16" if phase == "multiclass" else None,
                      "highest": None}[tier]
            _time_at_main_shape(main_ms, name, record,
                                lambda: gram_matmat.gram_matmat_sym(X, sq, V, precision=tier, **rbf),
                                _sym_bound(m, d, MC_CLASSES, "gram", 4, 1, TIER_OF.get(tier),
                                           exp=True),
                                f"{m}x{d} rbf C={MC_CLASSES} {tier}")
        rect_errs = {}
        for tier in ("f32", "bf16", "highest"):
            name, key = (("gram_matmat_rect_tc", ("gram_matmat_rect_tc", TIER_OF[tier]))
                         if tier != "highest" else ("gram_matmat_rect", "gram_matmat_rect"))
            rect_errs[tier] = _compare(K.RBF, 0.0, S, P, A, tier)[name]
            if tier != "bf16" or phase == "multiclass":
                main_err[key] = max(main_err.get(key, 0.0), rect_errs[tier][0])
            record = {"f32": phase, "bf16": "bf16" if phase == "multiclass" else None,
                      "highest": None}[tier]
            _time_at_main_shape(
                main_ms, name, record,
                lambda: gram_matmat.gram_matmat_rect(P, S, sq_p, sq_s, A, precision=tier, **rbf),
                _rect_bound(n_points, m + 1, d, MC_CLASSES, "gram", 4, 1, TIER_OF.get(tier),
                            exp=tier != "highest"),
                f"{n_points}x{m + 1}x{d} rbf C={MC_CLASSES} {tier}")
        _check_tf32_tier(f"gram_matmat_rect_tc {n_points}x{m + 1}x{d} rbf C={MC_CLASSES}",
                         gram_matmat.gram_matmat_rect(P, S, sq_p, sq_s, A, precision="f32", **rbf),
                         matvec.kernel_matmat_rect_plain(P, S, sq_p, sq_s, A, **rbf),
                         rbf["gamma"], float(torch.maximum(sq_s.max(), sq_p.max())))
        if phase == "mnist-width":
            _log_operand_time(X, f"{m}x{d}")
            _log_operand_time(P, f"{n_points}x{d} (points)")
            _log_operand_time(S, f"{m + 1}x{d} (support vectors)")
        log("kernels", f"main-path shapes f32, {MC_CLASSES} classes: sym {m}x{d} rbf "
            "max|err| " + ", ".join(f"{e[0]:.3e} ({t})" for t, e in errs.items())
            + f" (max|plain| {errs['highest'][1]:.3e}), rect {n_points}x{m + 1}x{d} rbf "
            + ", ".join(f"{e[0]:.3e} ({t})" for t, e in rect_errs.items())
            + f" (max|plain| {rect_errs['highest'][1]:.3e})")

    # timing: median of 20 launches each, m = 32768, d = 512, f32, RBF, the
    # rectangular kernels over the full square; kernels C and D against C =
    # 10 classes; the FFMA tile at "highest", the tensor-core tiles at "f32"
    # (TF32) and "bf16"
    m, d = 32768, 512
    X, _, v = _operands(m, d, torch.float32, gen, n_points=1)
    V = torch.randn(m, MC_CLASSES, generator=gen,
                    dtype=torch.float64).to("cuda", torch.float32)
    sq = (X * X).sum(-1)
    kw = dict(kind=K.RBF, gamma=1.0 / d, coef0=0.0, degree=3)
    flops = 2.0 * m * m * d
    timing, bounds = {}, {}
    for rhs in (v, V):
        columns = 1 if rhs.ndim == 1 else rhs.shape[1]
        label = f"m={m} d={d} f32 rbf" + (f" C={columns}" if rhs.ndim == 2 else "")
        for tier in ("highest", "f32", "bf16"):
            tc = TIER_OF.get(tier)
            sym_entry, rect_entry = _pairs(rhs, tier)
            for (name, kernel, plain), args, bound in (
                (sym_entry, (X, sq, rhs),
                 _sym_bound(m, d, columns, "gram", 4, 1, tc, exp=tc is not None)),
                (rect_entry, (X, X, sq, sq, rhs),
                 _rect_bound(m, m, d, columns, "gram", 4, 1, tc, exp=tc is not None)),
            ):
                key = name if tc is None else (name, tc)
                timing[key] = _time_pair(name, kernel, plain, args, kw, flops,
                                         f"{label} {tier}")
                bounds[key] = bound
                _log_bound(name, f"{label} {tier}", timing[key][0], bound)
    for mat, vec in (("gram_matmat_sym", "gram_matvec_sym"),
                     ("gram_matmat_rect", "gram_matvec_rect")):
        log("kernels", f"{mat} (C={MC_CLASSES}) / {vec} at m={m} d={d}: "
            f"{timing[mat][0] / timing[vec][0]:.3f}x the time")
    for tier in ("tf32", "bf16"):
        log("kernels", f"tensor-core tiles {tier} at m={m} d={d}: " + ", ".join(
            f"kernel {letter} {timing[name][0] / timing[(name + '_tc', tier)][0]:.2f}x"
            for letter, name in (("A", "gram_matvec_sym"), ("B", "gram_matvec_rect"),
                                 ("C", "gram_matmat_sym"), ("D", "gram_matmat_rect")))
            + " faster than the FFMA tile")

    # K6's port: kernel_matvec, one launch of kernel A at "f32" (the
    # tensor-core tile, TF32), at kernel A's shape
    timing["kernel_matvec"] = _time_pair(
        "kernel_matvec", gram_matvec.kernel_matvec,
        _tier_plain(matvec.kernel_matvec_plain, "f32"),
        (X, sq, v), kw, flops, f"m={m} d={d} f32 rbf")
    bounds["kernel_matvec"] = bounds[("gram_matvec_sym_tc", "tf32")]
    _log_bound("kernel_matvec", f"m={m} d={d} f32 rbf", timing["kernel_matvec"][0],
               bounds["kernel_matvec"])
    # product-only yardsticks: full-precision float32 (as the FFMA tile),
    # TF32 and bf16 (as the tensor-core tile's tiers)
    torch.backends.cuda.matmul.allow_tf32 = False
    _yardstick(f"torch.matmul(X, X.T) m={m} d={d} f32", lambda: torch.matmul(X, X.T))
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        _yardstick(f"torch.matmul(X, X.T) m={m} d={d} f32 allow_tf32",
                   lambda: torch.matmul(X, X.T))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    Xh = X.to(torch.bfloat16)
    _yardstick(f"torch.matmul(X, X.T) m={m} d={d} bf16", lambda: torch.matmul(Xh, Xh.T))
    del Xh
    # kernel_matvec on bench_matvec's shape (phase 12), RBF, against its
    # plain version on the TF32 operands; on one tile (m <= 64: one atomic
    # per row, so a fixed summation order) it equals kernel A bit for bit
    Xb, _, vb = _operands(BENCH_M, BENCH_D, torch.float32, gen, n_points=1)
    kwb = dict(kind=K.RBF, gamma=1.0 / BENCH_D, coef0=0.0, degree=3)
    sqb = (Xb * Xb).sum(-1)
    main_err["kernel_matvec"] = _check_close(
        f"kernel_matvec rbf {BENCH_M}x{BENCH_D}",
        gram_matvec.kernel_matvec(Xb, sqb, vb, **kwb),
        _tier_plain(matvec.kernel_matvec_plain, "f32")(Xb, sqb, vb, **kwb))[0]
    # one call, logged only: the cost ranking takes phase 12's loop time
    _time_at_main_shape(main_ms, "kernel_matvec", None,
                        lambda: gram_matvec.kernel_matvec(Xb, sqb, vb, **kwb),
                        _sym_bound(BENCH_M, BENCH_D, 1, "gram", 4, 1, "tf32", exp=True),
                        f"{BENCH_M}x{BENCH_D} rbf, one call")
    X1, _, v1 = _operands(64, 37, torch.float32, gen, n_points=1)
    sq1 = (X1 * X1).sum(-1)
    for tier in ("f32", "bf16", "highest"):
        if not torch.equal(gram_matvec.kernel_matvec(X1, sq1, v1, precision=tier, **kwb),
                           gram_matvec.gram_matvec_sym(X1, sq1, v1, precision=tier, **kwb)):
            raise AssertionError(f"kernel_matvec differs from kernel A at {tier} on one tile")
    log("kernels", f"kernel_matvec rbf {BENCH_M}x{BENCH_D} f32: max|err| "
        f"{main_err['kernel_matvec']:.3e} against the plain version on TF32 "
        "operands; equal to kernel A bit for bit on one tile (64 x 37) at "
        "f32, bf16 and highest")

    def time_a(X16):
        """Kernel A alone on the distance timing's rows, RBF."""
        sq16 = (X16 * X16).sum(-1)
        v16 = torch.ones(X16.shape[0], device="cuda", dtype=X16.dtype)
        kw16 = dict(kind=K.RBF, gamma=1.0 / X16.shape[1], coef0=0.0, degree=3)
        a_ms = _median_ms(lambda: gram_matvec.gram_matvec_sym(
            X16, sq16, v16, precision="highest", **kw16))
        log("kernels", f"gram_matvec_sym m={X16.shape[0]} d={X16.shape[1]} f32 rbf "
            f"highest: {a_ms:.3f} ms")
        return a_ms

    g_chi_ms = _distance_kernels(gen, main_err, main_ms, timing, bounds, time_a)
    _banded_kernels(gen, main_err, main_ms, timing, bounds)
    _dual_kernels(gen, main_err, main_ms, timing, bounds)
    _f64_kernels(gen, main_err, main_ms, timing, bounds)
    return main_err, main_ms, timing, bounds, g_chi_ms


def _dmma_blocks_per_sm():
    """The DMMA tiles' blocks per SM (symmetric, dual and rect) for every
    Gram kind, logged; raises if a block does not fit."""
    import ctypes

    from plssvm_tpu_torch.ops import _build

    lib = _build.load()
    for tile, query in (("gram_dmma_sym", lib.plssvm_gram_dmma_blocks_per_sm),
                        ("gram_dmma_dual", lib.plssvm_gram_dmma_dual_blocks_per_sm),
                        ("gram_dmma_rect", lib.plssvm_gram_dmma_rect_blocks_per_sm)):
        found = {}
        for kind, name in ((1, "poly"), (2, "rbf"), (3, "sigmoid")):
            blocks = ctypes.c_int(0)
            err = query(kind, ctypes.byref(blocks))
            if err != 0:
                raise AssertionError(f"{tile} {name}: occupancy query failed "
                                     f"({lib.plssvm_cuda_error_string(err).decode()})")
            found[name] = blocks.value
        log("kernels", f"{tile} blocks per SM: "
            + ", ".join(f"{k} {v}" for k, v in found.items()))
        if min(found.values()) < 1:
            raise AssertionError(f"{tile} does not fit an SM: {found}")


def _dmma_counter(matmat, walk="sym"):
    """The launches of the ``walk`` ("sym" or "rect") kernel's DMMA tile
    and its FFMA tile."""
    from plssvm_tpu_torch.ops import gram_matmat, gram_matvec

    module = gram_matmat if matmat else gram_matvec
    return getattr(module, f"{walk}_dmma_launches"), getattr(module, f"{walk}_launches")


def _time_f64_sym(main_ms, timing, bounds, main_err, X, V, kw, label, phase=None,
                  key=None, plain_repeats=3, yardstick=True):
    """Kernel A (V (m,)) or C (V (m, C)) in float64 at one shape: the DMMA
    tile against its plain version (held at 1e-10 of max|plain|, then both
    timed), both bounds (DMMA and DFMA) and float64 torch.matmul(X, X.T) as
    the product's yardstick, all logged.  At a main path's shape (``phase``) recorded for its cost line,
    with the error for the kernels line; the timing and bound under
    ``key``."""
    from plssvm_tpu_torch.ops import gram_matmat, gram_matvec, matvec

    matmat = V.ndim == 2
    name = "gram_matmat_sym_dmma" if matmat else "gram_matvec_sym_dmma"
    kernel = gram_matmat.gram_matmat_sym if matmat else gram_matvec.gram_matvec_sym
    plain = matvec.kernel_matmat_plain if matmat else matvec.kernel_matvec_plain
    sq = (X * X).sum(-1)
    m, d = X.shape
    columns = V.shape[1] if matmat else 1
    exp = str(kw["kind"]) == "rbf"
    before = _dmma_counter(matmat)
    got = kernel(X, sq, V, **kw)
    if _dmma_counter(matmat) != (before[0] + 1, before[1]):
        raise AssertionError(f"{name} {label}: not launched on the DMMA tile")
    err, _ = _check_close(f"{name} {label}", got, plain(X, sq, V, **kw))
    del got
    k_ms, p_ms = _time_pair(name, lambda: kernel(X, sq, V, **kw), lambda: plain(X, sq, V, **kw),
                            (), {}, 2.0 * m * m * d, label, plain_repeats=plain_repeats)
    dmma = _sym_bound(m, d, columns, "gram", 8, 1, "dmma", exp=exp)
    fp64 = _sym_bound(m, d, columns, "gram", 8, 1, "fp64")
    _log_bound(name, label, k_ms, dmma)
    log("kernels", f"{name} {label}: DMMA tile {k_ms:.3f} ms ({dmma[0] / k_ms:.3f} of the "
        f"DMMA bound {dmma[0]:.3f}, {fp64[0] / k_ms:.3f} of the DFMA bound {fp64[0]:.3f}); "
        f"plain {p_ms:.3f} ms")
    if yardstick:
        torch.cuda.empty_cache()
        _yardstick(f"torch.matmul(X, X.T) {m}x{d} f64 (DGEMM)", lambda: torch.matmul(X, X.T))
        torch.cuda.empty_cache()
    if phase is not None:
        main_ms[(name, phase)] = (k_ms, dmma[0])
        main_err[(name, "f64")] = max(main_err.get((name, "f64"), 0.0), err)
    if key is not None:
        timing[key], bounds[key] = (k_ms, p_ms), dmma
    return k_ms


def _time_f64_rect(main_ms, timing, bounds, main_err, args, kw, label, phase=None,
                   key=None, plain_repeats=3):
    """Kernel B (A (n_s,)) or D (A (n_s, C)) in float64 on ``args`` = (P, S,
    sq_p, sq_s, A): the rect DMMA tile against its plain version (held at
    1e-10 of max|plain|, one launch on the tile and none on the FFMA tile),
    then both timed, beside both bounds (DMMA and DFMA) and float64
    torch.matmul(P, S.T) as the product's yardstick, all logged.  At a main
    path's shape (``phase``) recorded for its cost line, with the error for
    the kernels line; the timing and bound under ``key``.  Returns the
    kernel's ms."""
    from plssvm_tpu_torch.ops import gram_matmat, gram_matvec, matvec

    P, S, _, _, A = args
    matmat = A.ndim == 2
    name = "gram_matmat_rect_dmma" if matmat else "gram_matvec_rect_dmma"
    kernel = gram_matmat.gram_matmat_rect if matmat else gram_matvec.gram_matvec_rect
    plain = matvec.kernel_matmat_rect_plain if matmat else matvec.kernel_matvec_rect_plain
    (n_p, d), n_s = P.shape, S.shape[0]
    columns = A.shape[1] if matmat else 1
    before = _dmma_counter(matmat, "rect")
    got = kernel(*args, **kw)
    if _dmma_counter(matmat, "rect") != (before[0] + 1, before[1]):
        raise AssertionError(f"{name} {label}: not launched on the rect DMMA tile only")
    err, _ = _check_close(f"{name} {label}", got, plain(*args, **kw))
    del got
    k_ms, p_ms = _time_pair(name, kernel, plain, args, kw, 2.0 * n_p * n_s * d, label,
                            plain_repeats=plain_repeats)
    dmma = _rect_bound(n_p, n_s, d, columns, "gram", 8, 1, "dmma",
                       exp=str(kw["kind"]) == "rbf")
    fp64 = _rect_bound(n_p, n_s, d, columns, "gram", 8, 1, "fp64")
    _log_bound(name, label, k_ms, dmma)
    torch.cuda.empty_cache()
    product_ms = _median_ms(lambda: torch.matmul(P, S.T), 5, 1)
    torch.cuda.empty_cache()
    log("kernels", f"{name} {label}: rect DMMA tile {k_ms:.3f} ms ({dmma[0] / k_ms:.3f} of "
        f"the DMMA bound {dmma[0]:.3f}, {fp64[0] / k_ms:.3f} of the DFMA bound "
        f"{fp64[0]:.3f}); plain {p_ms:.3f} ms ({p_ms / k_ms:.2f}x); yardstick "
        f"torch.matmul(P, S.T) {n_p}x{n_s}x{d} f64 (DGEMM, product only, not the same "
        f"function) {product_ms:.3f} ms ({k_ms / product_ms:.2f}x the tile's time)")
    if phase is not None:
        main_ms[(name, phase)] = (k_ms, dmma[0])
        main_err[(name, "f64")] = max(main_err.get((name, "f64"), 0.0), err)
    if key is not None:
        timing[key], bounds[key] = (k_ms, p_ms), dmma
    return k_ms


def _time_f64_dual(main_ms, timing, bounds, main_err, name, args, kw, label):
    """J or K in float64 at a ring block: the dual DMMA tile against its
    plain version (both outputs within 1e-10 of max|plain|, one launch on
    the tile and none on the FFMA walk), then both timed; both bounds (DMMA
    and DFMA) logged; recorded for the kernels line and the ring-f64 cost
    line (against the DMMA bound)."""
    kernel, plain = _dual_pair(name, "highest")
    module, counter = _dual_counter(name, torch.float64, "highest")
    (mr, d), mc = args[0].shape, args[1].shape[0]
    columns = args[-1].shape[1] if args[-1].ndim == 2 else 1
    exp = str(kw["kind"]) == "rbf"
    before = getattr(module, counter), module.dual_launches
    got = kernel(*args, **kw)
    if (getattr(module, counter), module.dual_launches) != (before[0] + 1, before[1]):
        raise AssertionError(f"{name} {label}: not launched on the dual DMMA tile only")
    want = plain(*args, **kw)
    key = (f"{name}_dmma", "f64")
    main_err[key] = _check_dual(label, got, want)[1]
    del got, want
    timing[key] = _time_pair(f"{name}_dmma", kernel, plain, args, kw, float(mr) * mc * d,
                             label, unit="Tpair-feature/s", counted="mr mc d")
    k_ms, p_ms = timing[key]
    bounds[key] = dmma = _dual_bound(mr, mc, d, columns, "gram", 8, 1, "dmma", exp=exp)
    fp64 = _dual_bound(mr, mc, d, columns, "gram", 8, 1, "fp64")
    _log_bound(f"{name}_dmma", label, k_ms, dmma)
    log("kernels", f"{name} {label}: dual DMMA tile {k_ms:.3f} ms ({dmma[0] / k_ms:.3f} of the "
        f"DMMA bound {dmma[0]:.3f}, {fp64[0] / k_ms:.3f} of the DFMA bound {fp64[0]:.3f}); "
        f"plain {p_ms:.3f} ms ({p_ms / k_ms:.2f}x)")
    main_ms[(f"{name}_f64", "ring-f64")] = (k_ms, dmma[0])
    if columns > 1:
        # the column atomics: one per column, class and tile, at 1 class
        # against all on the same block
        Xr, Xc, sq_r, sq_c, V_c, V_r = args
        one = (Xr, Xc, sq_r, sq_c, V_c[:, :1].contiguous(), V_r[:, :1].contiguous())
        one_ms = _median_ms(lambda: kernel(*one, **kw), 5, 1)
        log("kernels", f"column atomics {name}_dmma {label}: C=1 {one_ms:.3f} ms, "
            f"C={columns} {k_ms:.3f} ms (+{k_ms - one_ms:.3f}, {(k_ms - one_ms) / k_ms:.1%} "
            f"of the walk at C={columns})")


def _f64_kernels(gen, main_err, main_ms, timing, bounds):
    """Float64: kernels A and C on the symmetric DMMA tile, B and D on the
    rect one, J and K on the dual one (csrc/gram_dmma.cu); E-H, L and M
    in ``_f64_distance_kernels``.  The DMMA tiles' blocks per SM; A and C
    against their plain versions on ragged shapes beyond the general check
    (d from 1 to 1279, odd and even, m not a multiple of the 128-row tile,
    1 to 37 classes), each launch counted on the DMMA tile and none on the
    FFMA tile; B, D,
    J and K likewise on ragged n_p != n_s (mr != mc) blocks (1, 127, 129
    and 4097 rows, d 1 to 785, odd and even, 1 to 37 classes); the odd-d
    operand copy timed beside the kernel; A-D timed at 32768 x 512 (RBF),
    A at 49999 x 500 (poly, config 3's width) and C at 59999 x 784 (RBF,
    C = 10, MNIST's width), each beside its plain version, both bounds and
    DGEMM; then every float64 Gram kernel at the shape a float64 main path
    gives it (phases 4 and 5, the ring's one-device fits and its shards and
    blocks: J and K on the dual DMMA tile beside both bounds and K's
    classes at C = 1 against 10, and the rows-only walks B and D on the
    rect DMMA tile), A-D, J and K against their plain versions there (the
    float64 entries' max_abs_err), recorded for the cost ranking; and I in
    float64 at the timing shape of its float32 row, beside its bound."""
    from plssvm_tpu_torch.ops import banded, gram_matmat, gram_matvec, matvec
    from plssvm_tpu_torch.parameter import KernelFunctionType as K

    _dmma_blocks_per_sm()
    kinds = ((K.POLYNOMIAL, 1.0), (K.RBF, 0.0), (K.SIGMOID, -0.5))
    worst = {}
    for m, d in ((2100, 1), (128, 2), (257, 17), (300, 1279), (1, 1), (4097, 784)):
        X, _, _ = _operands(m, d, torch.float64, gen, n_points=1)
        sq = (X * X).sum(-1)
        for n_classes in (None, 1, 8, 9, 37):
            tail = () if n_classes is None else (n_classes,)
            V = torch.randn(m, *tail, generator=gen, dtype=torch.float64).to("cuda")
            matmat = n_classes is not None
            kernel = gram_matmat.gram_matmat_sym if matmat else gram_matvec.gram_matvec_sym
            plain = matvec.kernel_matmat_plain if matmat else matvec.kernel_matvec_plain
            for kind, coef0 in kinds:
                for precision in ("highest", "f32", "bf16"):
                    kw = dict(kind=kind, gamma=1.0 / d, coef0=coef0, degree=3,
                              precision=precision)
                    before = _dmma_counter(matmat)
                    got = kernel(X, sq, V, **kw)
                    label = f"DMMA {kind} {m}x{d} C={n_classes} {precision}"
                    if _dmma_counter(matmat) != (before[0] + 1, before[1]):
                        raise AssertionError(f"{label}: not launched on the DMMA tile only")
                    err, scale = _check_close(label, got, plain(X, sq, V, **kw))
                    name = "gram_matmat_sym_dmma" if matmat else "gram_matvec_sym_dmma"
                    worst[name] = max(worst.get(name, 0.0), err / max(scale, 1e-300))
    for name, rel in sorted(worst.items()):
        log("kernels", f"{name} float64: worst max|err|/max|plain| {rel:.3e} over poly/rbf/"
            "sigmoid x 6 ragged shapes (d 1-1279) x 1-37 classes x every tier")
    # the dual DMMA tile: mr != mc on both sides of the 128-row tile, odd d
    # and d = 1, 1 to 37 classes (across the 8-class staging chunk), every
    # tier
    worst = {}
    for mr, mc, d in ((1, 129, 1), (127, 4097, 3), (129, 127, 16), (4097, 1, 785),
                      (4097, 129, 2), (129, 4097, 37)):
        Xr = torch.randn(mr, d, generator=gen, dtype=torch.float64).to("cuda") * 0.3
        Xc = torch.randn(mc, d, generator=gen, dtype=torch.float64).to("cuda") * 0.3
        sq_r, sq_c = (Xr * Xr).sum(-1), (Xc * Xc).sum(-1)
        for n_classes in (None, 1, 8, 9, 37):
            tail = () if n_classes is None else (n_classes,)
            v_c = torch.randn(mc, *tail, generator=gen, dtype=torch.float64).to("cuda")
            v_r = torch.randn(mr, *tail, generator=gen, dtype=torch.float64).to("cuda")
            name = "gram_matvec_dual" if n_classes is None else "gram_matmat_dual"
            module, counter = _dual_counter(name, torch.float64, "highest")
            for kind, coef0 in kinds:
                for precision in ("highest", "f32", "bf16"):
                    kernel, plain = _dual_pair(name, precision)
                    args = (Xr, Xc, sq_r, sq_c, v_c, v_r)
                    kw = dict(kind=kind, gamma=1.0 / d, coef0=coef0, degree=3)
                    label = f"dual DMMA {kind} {mr}x{mc}x{d} C={n_classes} {precision}"
                    before = getattr(module, counter), module.dual_launches
                    got = kernel(*args, **kw)
                    if (getattr(module, counter), module.dual_launches) != (
                            before[0] + 1, before[1]):
                        raise AssertionError(f"{label}: not launched on the dual DMMA tile only")
                    rel, _ = _check_dual(label, got, plain(*args, **kw))
                    worst[name] = max(worst.get(name, 0.0), rel)
    for name, rel in sorted(worst.items()):
        log("kernels", f"{name}_dmma float64: worst max|err|/max|plain| {rel:.3e}, both "
            "outputs, over poly/rbf/sigmoid x 6 ragged mr != mc blocks (1-4097 rows, d 1-785) "
            "x 1-37 classes x every tier")
    # the rect DMMA tile: n_p != n_s on both sides of the 128-row tile, odd
    # d and d = 1, 1 to 37 classes, every tier
    worst = {}
    for n_p, n_s, d in ((1, 129, 1), (127, 4097, 3), (129, 127, 16), (4097, 1, 785),
                        (4097, 129, 2), (129, 4097, 37)):
        P = torch.randn(n_p, d, generator=gen, dtype=torch.float64).to("cuda") * 0.3
        S = torch.randn(n_s, d, generator=gen, dtype=torch.float64).to("cuda") * 0.3
        sq_p, sq_s = (P * P).sum(-1), (S * S).sum(-1)
        for n_classes in (None, 1, 8, 9, 37):
            tail = () if n_classes is None else (n_classes,)
            A = torch.randn(n_s, *tail, generator=gen, dtype=torch.float64).to("cuda")
            for kind, coef0 in kinds:
                for precision in ("highest", "f32", "bf16"):
                    _, (name, kernel, plain) = _pairs(A, precision)
                    kw = dict(kind=kind, gamma=1.0 / d, coef0=coef0, degree=3)
                    label = f"rect DMMA {kind} {n_p}x{n_s}x{d} C={n_classes} {precision}"
                    before = _dmma_counter(n_classes is not None, "rect")
                    got = kernel(P, S, sq_p, sq_s, A, **kw)
                    if _dmma_counter(n_classes is not None, "rect") != (before[0] + 1,
                                                                        before[1]):
                        raise AssertionError(f"{label}: not launched on the rect DMMA tile only")
                    err, scale = _check_close(label, got, plain(P, S, sq_p, sq_s, A, **kw))
                    worst[name] = max(worst.get(name, 0.0), err / max(scale, 1e-300))
    for name, rel in sorted(worst.items()):
        log("kernels", f"{name} float64: worst max|err|/max|plain| {rel:.3e} over "
            "poly/rbf/sigmoid x 6 ragged n_p != n_s blocks (1-4097 rows, d 1-785) x 1-37 "
            "classes x every tier")
    # an odd d: the wrapper's padded operand copy, timed beside the kernel
    X, _, v = _operands(49999, 499, torch.float64, gen, n_points=1)
    sq = (X * X).sum(-1)
    kw = dict(kind=K.RBF, gamma=1.0 / 499, coef0=0.0, degree=3)
    copy_ms = _median_ms(lambda: gram_matvec.dmma_operand(X), 5, 1)
    k_ms = _median_ms(lambda: gram_matvec.gram_matvec_sym(X, sq, v, **kw), 5, 1)
    log("kernels", f"gram_matvec_sym_dmma 49999x499 rbf f64 (odd d): the operand copy "
        f"padded to 500 {copy_ms:.3f} ms, {copy_ms / k_ms:.1%} of the launch's "
        f"{k_ms:.3f} ms (copy included)")
    del X, v, sq

    # the timing shape of A-D, RBF: A and C on the symmetric DMMA tile, B
    # and D on the rect one over the full square, against their plain
    # versions and both bounds
    m, d = 32768, 512
    X, _, v = _operands(m, d, torch.float64, gen, n_points=1)
    V = torch.randn(m, MC_CLASSES, generator=gen, dtype=torch.float64).to("cuda")
    kw = dict(kind=K.RBF, gamma=1.0 / d, coef0=0.0, degree=3)
    sq = (X * X).sum(-1)
    for rhs, sym in ((v, "gram_matvec_sym_dmma"), (V, "gram_matmat_sym_dmma")):
        label = f"m={m} d={d} f64 rbf" + (f" C={MC_CLASSES}" if rhs.ndim == 2 else "")
        _time_f64_sym(main_ms, timing, bounds, main_err, X, rhs, kw, label, key=(sym, "f64"),
                      plain_repeats=20, yardstick=rhs.ndim == 1)
        _time_f64_rect(main_ms, timing, bounds, main_err, (X, X, sq, sq, rhs), kw, label,
                       key=(_pairs(rhs)[1][0], "f64"), plain_repeats=20)
    del X, v, V, sq
    # config 3's width, polynomial on [-1, 1]: A
    X, _, v = _operands(49999, 500, torch.float64, gen, n_points=1)
    X = X / X.abs().amax(0)
    _time_f64_sym(main_ms, timing, bounds, main_err, X, v,
                  dict(kind=K.POLYNOMIAL, gamma=1.0 / 500, coef0=0.0, degree=3),
                  "49999x500 f64 poly")
    # the ring's one-device float64 fit at config 3's width is RBF
    _time_f64_sym(main_ms, timing, bounds, main_err, X, v,
                  dict(kind=K.RBF, gamma=1.0 / 500, coef0=0.0, degree=3),
                  "49999x500 f64 rbf", phase="ring-one-f64", yardstick=False)
    del X, v
    # MNIST's width, 10 classes: C (the ring's one-device float64 fit)
    X, _, V = _operands(59999, 784, torch.float64, gen, n_points=1, n_classes=MC_CLASSES)
    _time_f64_sym(main_ms, timing, bounds, main_err, X, V,
                  dict(kind=K.RBF, gamma=1.0 / 784, coef0=0.0, degree=3),
                  f"59999x784 f64 rbf C={MC_CLASSES}", phase="ring-one-f64")
    del X, V

    # phases 4 and 5's float64 fits and predicts: config 2's shape (9999 x
    # 200 training, 2000 points against 10000 SVs), RBF, 1 and 10 classes
    rbf = dict(kind=K.RBF, gamma=1.0 / 200, coef0=0.0, degree=3)
    for n_classes, phase in ((None, "e2e"), (MC_CLASSES, "multiclass")):
        X, P, V = _operands(9999, 200, torch.float64, gen, n_points=2000, n_classes=n_classes)
        S, A = torch.cat([X, X[:1]]), torch.cat([V, V[:1]])  # all m + 1 points
        sq, sq_p, sq_s = (X * X).sum(-1), (P * P).sum(-1), (S * S).sum(-1)
        sym, sym_k, sym_plain = _pairs(V)[0]
        columns = n_classes or 1
        err = _check_close(f"{sym} f64 {phase}", sym_k(X, sq, V, **rbf),
                           sym_plain(X, sq, V, **rbf))[0]
        main_err[(sym, "f64")] = max(main_err.get((sym, "f64"), 0.0), err)
        _time_at_main_shape(main_ms, sym, phase, lambda: sym_k(X, sq, V, **rbf),
                            _sym_bound(9999, 200, columns, "gram", 8, 1, "dmma", exp=True),
                            f"9999x200 f64 rbf C={columns}")
        _time_f64_rect(main_ms, timing, bounds, main_err, (P, S, sq_p, sq_s, A), rbf,
                       f"2000x10000x200 f64 rbf C={columns} (phase {phase}'s predict)",
                       phase=phase)

    # the ring's float64 Gram cells (4 shards): each shard's symmetric
    # product on the DMMA tile (12500 x 500 RBF, 15000 x 784 RBF C = 10),
    # the dual walks at the ring's blocks (J 12500^2 x 500 and K 15000^2 x
    # 784 C = 10 on the dual DMMA tile) and the rows-only walks B and D
    # (the rect DMMA tile) at J's and K's blocks, all also against their
    # plain versions (the distance cells: _f64_distance_kernels)
    for name, mr, d, n_classes, kind in (
        ("gram_matvec_dual", 12500, 500, None, K.RBF),
        ("gram_matmat_dual", 15000, 784, MC_CLASSES, K.RBF),
    ):
        tail = () if n_classes is None else (n_classes,)
        columns = n_classes or 1
        v_c = torch.randn(mr, *tail, generator=gen, dtype=torch.float64).to("cuda")
        v_r = torch.randn(mr, *tail, generator=gen, dtype=torch.float64).to("cuda")
        label = f"{mr}x{mr}x{d} f64 {kind}" + (f" C={columns}" if n_classes else "")
        X = torch.randn(2 * mr, d, generator=gen, dtype=torch.float64).to("cuda")
        if d == 500:
            X = X / X.abs().amax(0)  # config 3's [-1, 1] scale
        Xr, Xc = X[:mr].contiguous(), X[mr:].contiguous()
        sq_r = (Xr * Xr).sum(-1)
        args = (Xr, Xc, sq_r, (Xc * Xc).sum(-1), v_c, v_r)
        kw = dict(kind=kind, gamma=1.0 / d, coef0=0.0, degree=3)
        sym, sym_k, sym_plain = _pairs(v_c)[0]
        err = _check_close(f"{sym} {mr}x{d} f64 rbf (a shard)", sym_k(Xr, sq_r, v_c, **kw),
                           sym_plain(Xr, sq_r, v_c, **kw))[0]
        main_err[(sym, "f64")] = max(main_err.get((sym, "f64"), 0.0), err)
        _time_at_main_shape(main_ms, sym, "ring-f64", lambda: sym_k(Xr, sq_r, v_c, **kw),
                            _sym_bound(mr, d, columns, "gram", 8, 1, "dmma", exp=True),
                            f"{mr}x{d} f64 rbf C={columns} (a shard)")
        _time_f64_dual(main_ms, timing, bounds, main_err, name, args, kw, label)
        # the rows-only walk of the antipodal pair (even P): B or D on the
        # rect DMMA tile
        _time_f64_rect(main_ms, timing, bounds, main_err, args[:5], kw,
                       f"{label} (the rows-only walk)", phase="ring-f64")

    _f64_distance_kernels(gen, main_err, main_ms, timing, bounds)
    # kernel I in float64 at the timing shape of its float32 row, kernel
    # only (its plain version takes seconds a call there), against the FFMA
    # tile's float64 bound
    m, d = BANDED_M, BANDED_D
    X = torch.rand(m, d, generator=gen, dtype=torch.float64).to("cuda")
    XT, v = X.T.contiguous(), torch.randn(m, generator=gen, dtype=torch.float64).to("cuda")
    ms = _median_ms(lambda: banded.banded_matvec(XT, v, 1.0 / d), DIST_PLAIN_REPEATS, 1)
    _log_bound("banded_matvec", f"m={m} d={d} f64 laplacian", ms,
               _sym_bound(m, d, 1, "laplacian", 8, 1, "fp64"))
    del X, XT, v
    torch.cuda.empty_cache()


def _f64_distance_kernels(gen, main_err, main_ms, timing, bounds):
    """Kernels E-H, L and M in float64, chi-squared on the divide-free
    quotient (csrc/gram_tile.cuh ChiSquaredDistance) wherever a staged
    chunk lies within its range: first a host check that the histogram
    rows timed here and on the main paths do (``chi2_f64_in_range``); the
    ring's blocks, L (laplacian) and M (chi-squared, C = 10) at 2500^2 x
    200, both outputs against their plain versions, then timed beside them
    and the FP64-pipe bound; the ring's shard products E / G and the
    rows-only F / H (``_ring_distance_shards``); the ring's one-device
    float64 fits' kernels, E (laplacian) and G (chi-squared, C = 10) at
    9999 x 200, against plain and timed, with E-H per entry of K in
    chi-squared against a long double reference there and on the entry
    cases (``_chi2_f64_entry_ratios``), within 2x the float64 plain
    version's own error; E-H at m = 8192, d = 256,
    each beside its plain version (the float64 entries' times), and at m =
    16384, d = 256, kernel only (the plain versions take seconds a call
    there), kernel G there also on the same rows scaled by 1e-200, where
    every chunk takes the IEEE divide."""
    from plssvm_tpu_torch.ops import distance
    from plssvm_tpu_torch.ops.entry_check import chi2_f64_in_range
    from plssvm_tpu_torch.parameter import KernelFunctionType as K

    rng = np.random.default_rng(SEED + 22)
    hist = torch.as_tensor(_draw_histograms(rng, _histogram_classes(rng, 200), 10000)[0],
                           dtype=torch.float64, device="cuda")
    chi2_gamma = _chi2_gamma(rng, hist[:5000].cpu().numpy())
    if not chi2_f64_in_range(hist):
        raise AssertionError("the histogram rows lie outside the divide-free quotient's range")
    log("kernels", "float64 histogram rows (the ring's and phase 9's classes): every value "
        "0 or within the divide-free quotient's range (chi2_f64_in_range), so every chunk "
        "takes it")
    # the ring's blocks: L and M
    for name, n_classes, kind in (("distance_matvec_dual", None, K.LAPLACIAN),
                                  ("distance_matmat_dual", MC_CLASSES, K.CHI_SQUARED)):
        tail = () if n_classes is None else (n_classes,)
        columns = n_classes or 1
        v_c = torch.randn(2500, *tail, generator=gen, dtype=torch.float64).to("cuda")
        v_r = torch.randn(2500, *tail, generator=gen, dtype=torch.float64).to("cuda")
        if kind == K.CHI_SQUARED:
            X, gamma = hist, chi2_gamma
        else:
            X = torch.randn(5000, 200, generator=gen, dtype=torch.float64).to("cuda")
            gamma = 1.0 / 200
        args = (X[:2500].contiguous(), X[2500:5000].contiguous(), v_c, v_r)
        kw = dict(kind=kind, gamma=gamma)
        label = f"2500x2500x200 f64 {kind}" + (f" C={columns}" if n_classes else "")
        kernel, plain = _dual_pair(name, "highest")
        key = (name, "f64")
        main_err[key] = _check_dual(label, kernel(*args, **kw), plain(*args, **kw))[1]
        timing[key] = _time_pair(name, kernel, plain, args, kw, 2500.0 * 2500 * 200, label,
                                 plain_repeats=DIST_PLAIN_REPEATS, unit="Tpair-feature/s",
                                 counted="mr mc d")
        bounds[key] = _dual_bound(2500, 2500, 200, columns, str(kind), 8, 0, "fp64")
        _log_bound(name, label, timing[key][0], bounds[key])
        main_ms[(f"{name}_f64", "ring-f64")] = (timing[key][0], bounds[key][0])
    lap = torch.randn(5000, 200, generator=gen, dtype=torch.float64).to("cuda")
    _ring_distance_shards(gen, main_err, main_ms, lap, hist, chi2_gamma, "ring-f64")

    # the ring's one-device float64 fits: E (laplacian, config 2's width)
    # and G (chi-squared, phase 9's shape, C = 10), and E-H per entry
    X = hist[:9999].contiguous()
    P = hist[9999 - 2000:].contiguous()  # 2000 points against the 9999 rows
    V = torch.randn(9999, MC_CLASSES, generator=gen, dtype=torch.float64).to("cuda")
    Xl = torch.randn(9999, 200, generator=gen, dtype=torch.float64).to("cuda")
    for name, kernel, rows, rhs, kind, gamma in (
        ("distance_matvec_sym", distance.distance_matvec_sym, Xl, V[:, 0].contiguous(),
         K.LAPLACIAN, 1.0 / 200),
        ("distance_matmat_sym", distance.distance_matmat_sym, X, V, K.CHI_SQUARED,
         chi2_gamma),
    ):
        plain = _distance_pairs(rhs)[0][2]
        kw = dict(kind=kind, gamma=gamma)
        columns = 1 if rhs.ndim == 1 else MC_CLASSES
        label = f"9999x200 f64 {kind} C={columns} (the one-device fit)"
        err = _check_close(f"{name} {label}", kernel(rows, rhs, **kw), plain(rows, rhs, **kw))[0]
        main_err[(name, "f64")] = max(main_err.get((name, "f64"), 0.0), err)
        _time_at_main_shape(main_ms, f"{name}_f64", "ring-one-f64", lambda: kernel(rows, rhs, **kw),
                            _sym_bound(9999, 200, columns, str(kind), 8, 0, "fp64"), label)
    worst = _chi2_f64_entry_ratios(X, P, chi2_gamma)
    if max(worst.values()) > 2:
        raise AssertionError(f"float64 chi-squared per entry past 2x the plain version: {worst}")
    del X, P, V, Xl, lap, hist

    # E-H beside their plain versions at m = 8192, then kernel only at m =
    # 16384, d = 256, on histogram rows (C = 10 for G and H), against the
    # FFMA tile's float64 bound
    for m, with_plain in ((8192, True), (16384, False)):
        d = 256
        X = torch.as_tensor(_draw_histograms(rng, _histogram_classes(rng, d), m)[0],
                            dtype=torch.float64, device="cuda")
        if not chi2_f64_in_range(X):
            raise AssertionError(f"the {m}x{d} histogram rows lie outside the quotient's range")
        v = torch.randn(m, generator=gen, dtype=torch.float64).to("cuda")
        V = torch.randn(m, MC_CLASSES, generator=gen, dtype=torch.float64).to("cuda")
        for kind in (K.LAPLACIAN, K.CHI_SQUARED):
            kw = dict(kind=kind, gamma=1.0 / d)
            for rhs in (v, V):
                columns = 1 if rhs.ndim == 1 else MC_CLASSES
                label = f"m={m} d={d} f64 {kind}" + (f" C={columns}" if rhs.ndim == 2 else "")
                for name, kernel, plain in _distance_pairs(rhs):
                    args = (X, rhs) if "sym" in name else (X, X, rhs)
                    bound = (_sym_bound(m, d, columns, str(kind), 8, 0, "fp64") if "sym" in name
                             else _rect_bound(m, m, d, columns, str(kind), 8, 0, "fp64"))
                    if with_plain:
                        # the float64 entries: E and F laplacian, G and H
                        # chi-squared, as the float32 ones
                        key = ((name, "f64") if ("matvec" in name) == (kind == K.LAPLACIAN)
                               else (name, "f64 " + str(kind)))
                        timing[key] = _time_pair(name, kernel, plain, args, kw,
                                                 float(m) * m * d, label, plain_repeats=1,
                                                 unit="Tpair-feature/s", counted="m^2 d")
                        bounds[key] = bound
                        ms = timing[key][0]
                    else:
                        ms = _median_ms(lambda: kernel(*args, **kw), DIST_PLAIN_REPEATS, 1)
                    _log_bound(name, label, ms, bound)
        if not with_plain:
            # every chunk out of range: kernel G on the IEEE divide
            kw = dict(kind=K.CHI_SQUARED, gamma=1.0 / d)
            fast = _median_ms(lambda: distance.distance_matmat_sym(X, V, **kw),
                              DIST_PLAIN_REPEATS, 1)
            tiny = X * 1e-200
            ieee = _median_ms(lambda: distance.distance_matmat_sym(tiny, V, **kw),
                              DIST_PLAIN_REPEATS, 1)
            log("kernels", f"distance_matmat_sym m={m} d={d} f64 chi_squared C={MC_CLASSES}: "
                f"{fast:.3f} ms on the rows (the divide-free quotient), {ieee:.3f} ms on the "
                f"rows x 1e-200 (every chunk on the IEEE divide), {ieee / fast:.2f}x")
            del tiny
        del X, v, V
    torch.cuda.empty_cache()


def _chi2_f64_entry_ratios(X, P, gamma):
    """Kernels E-H in float64 chi-squared per entry of K against long
    double (``entry_errors``): on the rows X at 10 columns of K, P the
    points of F and H, and on ``entry_cases`` at d = 203 and 784, the out
    of range ones included (gamma of their own), each kernel's worst
    relative error logged beside the float64 plain version's; returns
    {case: the worst ratio of the four kernels}."""
    from plssvm_tpu_torch.ops import distance
    from plssvm_tpu_torch.ops.entry_check import (chi2_f64_in_range, chi2_gamma,
                                                  entry_cases, entry_errors)

    m, d = X.shape
    cases = [(f"{m}x{d}", X, [int(j) for j in np.linspace(0, m - 1, MC_CLASSES)], P, gamma)]
    for d_case in (203, 784):
        for name, Xc, columns in entry_cases(d_case, torch.Generator().manual_seed(46),
                                             out_of_range=True):
            Xc = Xc.to("cuda")
            cases.append((f"{name} d={d_case}", Xc, columns, Xc, chi2_gamma(Xc, columns)))
    worst = {}
    for label, rows, columns, points, g in cases:
        found = []
        for name, kernel, rect, one_column in (
            ("E", distance.distance_matvec_sym, False, True),
            ("F", distance.distance_matvec_rect, True, True),
            ("G", distance.distance_matmat_sym, False, False),
            ("H", distance.distance_matmat_rect, True, False),
        ):
            got, plain = entry_errors(kernel, rows, columns, g,
                                      points=points if rect else None, one_column=one_column)
            found.append(f"{name} {got:.3e} ({got / plain:.2f}x)")
            worst[label] = max(worst.get(label, 0.0), got / plain)
        log("kernels", f"per-entry f64 chi-squared {label} ({len(columns)} columns of K, "
            f"{'within' if chi2_f64_in_range(rows) else 'outside'} the divide-free range), "
            f"against long double, worst rel err and its ratio to the float64 plain "
            f"version's: " + ", ".join(found))
    return worst


def _chi2_f64_times():
    """What ``--compare-build`` times in each checkout, in a process of its
    own, through wrappers and a CSVM that the parent has too: kernels E-H in
    float64 on histogram rows at m = 16384, d = 256 (C = 10 for G and H),
    laplacian and chi-squared, L and M at the ring's block (2500^2 x 200,
    M with C = 10), G in float32 at phase 10's shape (59999 x 784, C = 10),
    each the median ms of 5 after 1 warm-up beside its bound; and the
    float64 chi-squared fit of phase 9's classes (10000 x 200, 10 classes,
    epsilon 1e-10) on one device and on the four-shard ring, s/iteration.
    Returns {label: [value, bound ms or None]}."""
    import plssvm_tpu_torch as port
    from plssvm_tpu_torch.ops import distance
    from plssvm_tpu_torch.parameter import KernelFunctionType as K

    port.set_verbosity("quiet")
    gen = torch.Generator().manual_seed(SEED)
    rng = np.random.default_rng(SEED + 23)
    out = {}
    m, d = 16384, 256
    X = torch.as_tensor(_draw_histograms(rng, _histogram_classes(rng, d), m)[0],
                        dtype=torch.float64, device="cuda")
    v = torch.randn(m, generator=gen, dtype=torch.float64).to("cuda")
    V = torch.randn(m, MC_CLASSES, generator=gen, dtype=torch.float64).to("cuda")
    for kind in (K.CHI_SQUARED, K.LAPLACIAN):
        kw = dict(kind=kind, gamma=1.0 / d)
        for rhs in (v, V):
            columns = 1 if rhs.ndim == 1 else MC_CLASSES
            for name, kernel, _ in _distance_pairs(rhs):
                args = (X, rhs) if "sym" in name else (X, X, rhs)
                bound = (_sym_bound(m, d, columns, str(kind), 8, 0, "fp64") if "sym" in name
                         else _rect_bound(m, m, d, columns, str(kind), 8, 0, "fp64"))
                out[f"{name} f64 {kind} {m}x{d} C={columns}"] = [
                    _median_ms(lambda: kernel(*args, **kw), 5, 1), bound[0]]
    del X, v, V
    hist = torch.as_tensor(_draw_histograms(rng, _histogram_classes(rng, 200), 5000)[0],
                           dtype=torch.float64, device="cuda")
    for name, kernel, kind, gamma, columns in (
        ("distance_matmat_dual", distance.distance_matmat_dual, K.CHI_SQUARED,
         _chi2_gamma(rng, hist.cpu().numpy()), MC_CLASSES),
        ("distance_matvec_dual", distance.distance_matvec_dual, K.LAPLACIAN, 1.0 / 200, 1),
    ):
        tail = (columns,) if columns > 1 else ()
        Xr, Xc = hist[:2500].contiguous(), hist[2500:].contiguous()
        v_c, v_r = (torch.randn(2500, *tail, generator=gen, dtype=torch.float64).to("cuda")
                    for _ in range(2))
        out[f"{name} f64 {kind} 2500x2500x200 C={columns}"] = [
            _median_ms(lambda: kernel(Xr, Xc, v_c, v_r, kind=kind, gamma=gamma), 5, 1),
            _dual_bound(2500, 2500, 200, columns, str(kind), 8, 0, "fp64")[0]]
    del hist
    X = torch.as_tensor(_draw_histograms(rng, _histogram_classes(rng, 784), 59999)[0],
                        dtype=torch.float32, device="cuda")
    V = torch.randn(59999, MC_CLASSES, generator=gen, dtype=torch.float64).to("cuda",
                                                                              torch.float32)
    out[f"distance_matmat_sym f32 chi_squared 59999x784 C={MC_CLASSES}"] = [
        _median_ms(lambda: distance.distance_matmat_sym(X, V, kind=K.CHI_SQUARED,
                                                        gamma=1.0 / 784), 5, 1),
        _sym_bound(59999, 784, MC_CLASSES, "chi_squared", 4)[0]]
    del X, V
    # phase 9's classes, in memory
    rng = np.random.default_rng(SEED + 12)
    probs = _histogram_classes(rng, 200)
    X, y, _ = _draw_histograms(rng, probs, 10000)
    X_test, y_test, _ = _draw_histograms(rng, probs, 2000)
    cell = dict(labels=y_test, params=dict(kernel_type="chi_squared",
                                           gamma=_chi2_gamma(rng, X)))
    data = (port.DataSet(X, y, dtype=np.float64), port.DataSet(X_test, y_test, dtype=np.float64))
    for label, devices in (("one device", None), ("ring", ["cuda:0"] * RING_SHARDS)):
        run = _ring_run(cell, *data, np.float64, RING_F64_EPSILON, devices)
        fit = f"chi-squared f64 fit, 10000x200, {MC_CLASSES} classes, {label}"
        out[f"{fit}: s/iteration"] = [run["s_per_it"], None]
        out[f"{fit}: iterations"] = [run["iterations"], None]
    return out


#: run in a checkout: import the package there and print _chi2_f64_times()
#: of the chip_smoke.py named by the first argument
_TIMES = (
    "import importlib.util, json, sys; "
    "spec = importlib.util.spec_from_file_location('chip_smoke', sys.argv[1]); "
    "smoke = importlib.util.module_from_spec(spec); spec.loader.exec_module(smoke); "
    "print(json.dumps(smoke._chi2_f64_times()))"
)


def phase_compare(other):
    """``--compare-build``: ``_chi2_f64_times`` in the other checkout (its
    kernels, built in the build phase) and in this one, each in a process
    of its own, in the order other, here, here, other; per label both
    checkouts' times, the faster of each pair, their ratio and the shares
    of the bound, logged."""
    here = os.path.dirname(os.path.abspath(__file__))
    runs = []
    for root in (other, here, here, other):
        proc = subprocess.run([sys.executable, "-c", _TIMES, os.path.abspath(__file__)],
                              cwd=root, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise AssertionError(f"the timings in {root} failed:\n{proc.stderr[-3000:]}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    for label, (_, bound) in runs[0].items():
        theirs = [runs[0][label][0], runs[3][label][0]]
        mine = [runs[1][label][0], runs[2][label][0]]
        share = (f"; share of the bound {bound:.3f} ms: {bound / min(theirs):.3f} there, "
                 f"{bound / min(mine):.3f} here" if bound else "")
        log("compare", f"{label}: {other} {theirs[0]:.6g}, {theirs[1]:.6g}; here {mine[0]:.6g}, "
            f"{mine[1]:.6g}; {min(theirs) / min(mine):.3f}x{share}")


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
    float32 run's labels on >= 99.5 % of the points; returns its CG
    iterations."""
    import plssvm_tpu_torch as port

    train64 = port.DataSet(train_file, dtype=np.float64)
    test64 = port.DataSet(test_file, dtype=np.float64)
    svm64 = port.CSVM(backend="cuda", device="cuda", dtype=np.float64,
                      cost=1.0, **params)
    port.global_tracker.clear()
    t0 = time.perf_counter()
    model64 = svm64.fit(train64, epsilon=epsilon)
    t1 = time.perf_counter()
    cg_s = _tracked("cg", "total_runtime") / 1000
    agree = float(np.mean(svm64.predict(model64, test64) == predicted))
    log(phase, f"{label} f64 (cuda): {model64.n_iter} CG iterations, "
        f"{cg_s / max(model64.n_iter, 1):.6f} s/iteration, fit {t1 - t0:.3f} s, "
        f"f32/f64 label agreement {agree:.4f}")
    if agree < 0.995:
        raise AssertionError(f"f32 and f64 agree on {agree} of the labels")
    return model64.n_iter


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
        "gram_matvec_sym_tc": gram_matvec.sym_tc_launches,
        "gram_matvec_rect_tc": gram_matvec.rect_tc_launches,
    }
    if gram_matvec.sym_launches + gram_matvec.rect_launches != 0:
        raise AssertionError("e2e: the f32 fit or predict took the FFMA tile")
    _check_cli_run("e2e", "config 2", fit_s, predict_s,
                   float(np.mean(predicted == test_labels)), ACCURACY_FLOOR,
                   launches, matvec.sym_plain_calls + matvec.rect_plain_calls,
                   "gram_matvec_sym_tc", "gram_matvec_rect_tc")
    # float64: kernels A and B on the DMMA tiles
    gram_matvec.reset_counts()
    it64 = _f64_agreement("e2e", "config 2", train_file, test_file, predicted,
                          EPSILON, kernel_type="rbf")
    launches["gram_matvec_sym_dmma"] = gram_matvec.sym_dmma_launches
    launches["gram_matvec_rect_dmma"] = gram_matvec.rect_dmma_launches
    log("e2e", f"config 2 f64 launches: A on the DMMA tile {gram_matvec.sym_dmma_launches}, "
        f"on the FFMA tile {gram_matvec.sym_launches}; B on the rect DMMA tile "
        f"{gram_matvec.rect_dmma_launches}, on the FFMA tile {gram_matvec.rect_launches}; "
        f"tensor-core tiles {gram_matvec.sym_tc_launches + gram_matvec.rect_tc_launches}")
    if launches["gram_matvec_sym_dmma"] != 1 + it64 + it64 // 50 \
            or gram_matvec.sym_launches + gram_matvec.rect_launches != 0 \
            or launches["gram_matvec_rect_dmma"] <= 0 \
            or gram_matvec.sym_tc_launches + gram_matvec.rect_tc_launches:
        raise AssertionError("e2e: the f64 fit or its predict did not take the DMMA tiles "
                             "only")
    _small_fit_agreement("e2e", "rbf", 2, SEED + 1)
    return launches, predicted


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
        "gram_matmat_sym_tc": gram_matmat.sym_tc_launches,
        "gram_matmat_rect_tc": gram_matmat.rect_tc_launches,
    }
    if (gram_matvec.sym_launches + gram_matvec.sym_tc_launches
            + gram_matvec.rect_launches + gram_matvec.rect_tc_launches
            + gram_matmat.sym_launches + gram_matmat.rect_launches) != 0:
        raise AssertionError("multiclass launched the binary kernels or the FFMA tile")
    _check_cli_run("multiclass", f"{MC_CLASSES} classes", fit_s, predict_s,
                   float(np.mean(predicted == files["mc_test"][1])),
                   MC_ACCURACY_FLOOR, launches,
                   matvec.sym_matmat_plain_calls + matvec.rect_matmat_plain_calls,
                   "gram_matmat_sym_tc", "gram_matmat_rect_tc")
    # float64: kernels C and D on the DMMA tiles
    gram_matmat.reset_counts()
    it64 = _f64_agreement("multiclass", f"{MC_CLASSES} classes", train_file,
                          test_file, predicted, EPSILON, kernel_type="rbf")
    launches["gram_matmat_sym_dmma"] = gram_matmat.sym_dmma_launches
    launches["gram_matmat_rect_dmma"] = gram_matmat.rect_dmma_launches
    log("multiclass", f"{MC_CLASSES} classes f64 launches: C on the DMMA tile "
        f"{gram_matmat.sym_dmma_launches}, on the FFMA tile {gram_matmat.sym_launches}; D on "
        f"the rect DMMA tile {gram_matmat.rect_dmma_launches}, on the FFMA tile "
        f"{gram_matmat.rect_launches}; tensor-core tiles "
        f"{gram_matmat.sym_tc_launches + gram_matmat.rect_tc_launches}")
    if launches["gram_matmat_sym_dmma"] != 1 + it64 + it64 // 50 \
            or gram_matmat.sym_launches + gram_matmat.rect_launches != 0 \
            or launches["gram_matmat_rect_dmma"] <= 0 \
            or gram_matmat.sym_tc_launches + gram_matmat.rect_tc_launches:
        raise AssertionError("multiclass: the f64 fit or its predict did not take the DMMA "
                             "tiles only")
    _small_fit_agreement("multiclass", "rbf", 4, SEED + 5)
    return launches, (train_file, test_file, files["mc_test"][1], predicted)


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
    launches = (gram_matmat.sym_tc_launches, gram_matmat.rect_tc_launches)
    plain_calls = matvec.sym_matmat_plain_calls + matvec.rect_matmat_plain_calls
    iterations = _tracked("cg", "iterations")
    cg_ms = _tracked("cg", "total_runtime")
    accuracy = float(np.mean(predicted == y_test))
    log("mnist-width", f"rbf 60000x784 {MC_CLASSES} classes f32 (cuda): "
        f"{iterations} block-CG iterations (per class "
        f"{_tracked('cg', 'iterations_per_class')}), "
        f"{cg_ms / 1000 / iterations:.6f} s/iteration, fit {t1 - t0:.3f} s, "
        f"predict 10000 points {t2 - t1:.3f} s, accuracy {accuracy:.4f}, "
        f"kernel C / D (tensor cores, TF32) launches {launches}, matmat plain "
        f"calls {plain_calls}")
    if not (np.all(np.isfinite(model.alpha)) and np.all(np.isfinite(model.rho))):
        raise AssertionError("MNIST width: non-finite model")
    if launches[0] != 1 + iterations + iterations // 50 or launches[1] <= 0 \
            or plain_calls != 0 or gram_matmat.sym_launches + gram_matmat.rect_launches:
        raise AssertionError("MNIST width did not go through the tensor-core C and D only")
    if accuracy < MC_ACCURACY_FLOOR:
        raise AssertionError(f"accuracy {accuracy} below {MC_ACCURACY_FLOOR}")
    cell = dict(make=lambda dtype: (port.DataSet(X, y, dtype=dtype),
                                    port.DataSet(X_test, y_test, dtype=dtype)),
                labels=y_test, epsilon=EPSILON, floor=MC_ACCURACY_FLOOR,
                params=dict(kernel_type="rbf"))
    return {"gram_matmat_sym_tc": launches[0], "gram_matmat_rect_tc": launches[1]}, cell


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
        f"kernel A launches: tensor cores (TF32) {gram_matvec.sym_tc_launches}, "
        f"FFMA tile {gram_matvec.sym_launches}")
    if (gram_matvec.sym_tc_launches != 1 + iterations + iterations // 50
            or gram_matvec.sym_launches != 0):
        raise AssertionError("config 3 width did not go through the tensor-core A only")
    return {"gram_matvec_sym_tc": gram_matvec.sym_tc_launches}


def phase_bf16(tmp, config2_files, e2e_predicted, multiclass_files):
    """The "bf16" tier end to end: phase 4's config 2 files and phase 5's
    10-class files trained through ``plssvm-torch-train --gram_precision
    bf16`` and predicted through ``CSVM(gram_precision="bf16")``: kernels
    A-D on the tensor-core tiles with bf16 operands.  Accuracy floors as
    phases 4 and 5; the label agreement with the "f32" runs is logged."""
    import plssvm_tpu_torch as port
    from plssvm_tpu_torch.cli import train as train_cli
    from plssvm_tpu_torch.ops import gram_matmat, gram_matvec, matvec

    (train_file, _), (test_file, test_labels) = config2_files
    mc_train, mc_test, mc_labels, mc_predicted = multiclass_files
    launches = {}
    for label, train, test, labels, f32_predicted, floor, sym, rect in (
        ("config 2", train_file, test_file, test_labels, e2e_predicted,
         ACCURACY_FLOOR, "gram_matvec_sym_tc", "gram_matvec_rect_tc"),
        (f"{MC_CLASSES} classes", mc_train, mc_test, mc_labels, mc_predicted,
         MC_ACCURACY_FLOOR, "gram_matmat_sym_tc", "gram_matmat_rect_tc"),
    ):
        gram_matvec.reset_counts()
        gram_matmat.reset_counts()
        model_file = os.path.join(tmp, f"bf16-{sym}.model")
        port.global_tracker.clear()
        t0 = time.perf_counter()
        rc = train_cli.main(["-b", "cuda", "-p", "gpu", "-q", "--gram_precision", "bf16",
                             "-t", "2", "-c", "1", "-e", str(EPSILON), train, model_file])
        t1 = time.perf_counter()
        if rc != 0:
            raise AssertionError(f"bf16 {label}: train rc {rc}")
        svm = port.CSVM(backend="cuda", device="cuda", gram_precision="bf16")
        predicted = svm.predict(port.Model.load(model_file), port.DataSet(test))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        iterations = _tracked("cg", "iterations")
        cg_ms = _tracked("cg", "total_runtime")
        module = gram_matvec if sym.startswith("gram_matvec") else gram_matmat
        counts = {sym: module.sym_tc_launches, rect: module.rect_tc_launches}
        launches.update(counts)
        ffma = (gram_matvec.sym_launches + gram_matmat.sym_launches
                + gram_matvec.rect_launches + gram_matmat.rect_launches)
        plain = (matvec.sym_plain_calls + matvec.rect_plain_calls
                 + matvec.sym_matmat_plain_calls + matvec.rect_matmat_plain_calls)
        accuracy = float(np.mean(predicted == labels))
        agree = float(np.mean(predicted == f32_predicted))
        log("bf16", f"{label} bf16 (cuda): {iterations} CG iterations, "
            f"{cg_ms / 1000 / iterations:.6f} s/iteration, fit (CLI) {t1 - t0:.3f} s, "
            f"predict (CSVM, file parse included) {t2 - t1:.3f} s, accuracy "
            f"{accuracy:.4f}, label agreement with the f32 run {agree:.4f}, launches "
            f"{counts}, FFMA-tile launches {ffma}, plain calls {plain}")
        if counts[sym] != 1 + iterations + iterations // 50 or counts[rect] <= 0 \
                or ffma != 0 or plain != 0:
            raise AssertionError(f"bf16 {label} did not go through the bf16 kernels only")
        if accuracy < floor:
            raise AssertionError(f"bf16 {label}: accuracy {accuracy} below {floor}")
    return launches


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
    cell = _cli_cell(train_file, test_file, test_labels, EPSILON,
                     LAPLACIAN_ACCURACY_FLOOR, kernel_type="laplacian")
    _f64_agreement("laplacian", "config 2 -t 4", train_file, test_file,
                   predicted, EPSILON, kernel_type="laplacian")
    _small_fit_agreement("laplacian", "laplacian", 2, SEED + 11)
    return {k: launches[k] for k in ("distance_matvec_sym", "distance_matvec_rect")}, cell


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
    cell = _cli_cell(train_file, test_file, y_test, CHI2_EPSILON,
                     CHI2_ACCURACY_FLOOR, kernel_type="chi_squared", gamma=gamma)
    _f64_agreement("chi2-cli", f"{MC_CLASSES} classes -t 5", train_file,
                   test_file, predicted, CHI2_EPSILON,
                   kernel_type="chi_squared", gamma=gamma)
    return {k: launches[k] for k in ("distance_matmat_sym", "distance_matmat_rect")}, cell


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


def _cli_cell(train_file, test_file, labels, epsilon, floor, **params):
    """A ring cell of a CLI phase's files: ``make(dtype)`` reads them as
    DataSets of that type."""
    import plssvm_tpu_torch as port

    return dict(make=lambda dtype: (port.DataSet(train_file, dtype=dtype),
                                    port.DataSet(test_file, dtype=dtype)),
                labels=labels, epsilon=epsilon, floor=floor, params=params)


def _config3_rbf_cell():
    """The ring's binary cell at BASELINE config 3's width: RBF on 50000 x
    500 scaled to [-1, 1], two Gaussian classes whose means differ by
    0.0632 per feature, so the Bayes-optimal accuracy is config 2's (~0.92:
    0.1 per feature at d = 200), 2000 held out."""
    import plssvm_tpu_torch as port

    rng = np.random.default_rng(SEED + 21)
    n, d = 52000, 500
    y = np.where(rng.random(n) < 0.5, -1, 1)
    X = rng.normal(size=(n, d)) + 0.1 * np.sqrt(200 / d) * y[:, None]

    def make(dtype):
        train = port.DataSet(X[:50000], y[:50000], scaling=(-1.0, 1.0), dtype=dtype)
        return train, port.DataSet(X[50000:], y[50000:], scaling=train.scaling_factors,
                                   dtype=dtype)

    return dict(make=make, labels=y[50000:], epsilon=EPSILON, floor=ACCURACY_FLOOR,
                params=dict(kernel_type="rbf"))


def _ring_copy_ms(X, iteration_s, label):
    """The operand copies the ring makes per CG iteration at the "f32" tier,
    on one shard of X: per shard and product, the symmetric tensor-core
    tile's copy of X_p, the dual tile's copies of X_p and X_q (once per
    dual step) and the rectangular tile's copies of both (for even P), all
    ``tier_operand``; logged beside the iteration."""
    from plssvm_tpu_torch.ops import gram_matvec
    from plssvm_tpu_torch.parallel import sharded

    lo, hi = sharded.shard_bounds(X.shape[0], RING_SHARDS)[0]
    shard = X[lo:hi]
    tc = _median_ms(lambda: gram_matvec.tier_operand(shard, "f32"), 5, 1)
    steps = (RING_SHARDS - 1) // 2
    copies = 1 + 2 * steps + 2 * (RING_SHARDS % 2 == 0)
    total = RING_SHARDS * copies * tc
    log("ring", f"{label}: operand copies per iteration {total:.3f} ms ({RING_SHARDS} shards "
        f"x {copies} tier_operand of {tc:.3f} ms: symmetric 1, dual {2 * steps}, rows-only "
        f"{2 * (RING_SHARDS % 2 == 0)}), {total / 1000 / iteration_s:.3%} of the iteration")


def _ring_dmma_copies(X, label):
    """Which of the float64 ring's row shards of X reach the DMMA tiles as
    they are (``dmma_operand`` returns the view: d even, 16-byte aligned)
    and which take a copy; logged, with the copies' ms per iteration."""
    from plssvm_tpu_torch.ops import gram_matvec
    from plssvm_tpu_torch.parallel import sharded

    bounds = sharded.shard_bounds(X.shape[0], RING_SHARDS)
    shards = sharded.shard_rows(X, bounds, [X.device] * RING_SHARDS)
    copied = [i for i, shard in enumerate(shards)
              if gram_matvec.dmma_operand(shard).data_ptr() != shard.data_ptr()]
    ms = sum(_median_ms(lambda: gram_matvec.dmma_operand(shards[i]), 5, 1) for i in copied)
    # per iteration each shard feeds its symmetric product once, each dual
    # walk twice (as Xr and as Xc) and, for even P, the rows-only walk twice
    # (as P and as S)
    per_it = (1 + 2 * ((RING_SHARDS - 1) // 2) + 2 * (RING_SHARDS % 2 == 0)) * ms
    log("ring", f"{label} float64: {RING_SHARDS - len(copied)} of {RING_SHARDS} shard views "
        f"(d = {X.shape[1]}) reach the DMMA tiles without a copy; copied {copied or 'none'}"
        + (f", {per_it:.3f} ms of copies per iteration" if copied else ""))


def _ring_counts(kind, matmat, dtype):
    """(dual kernel's name, [symmetric, dual, rows-only launches], launches
    on the tiles the dtype must not take, plain calls) since the last
    reset: float32 Gram products on the tensor-core tiles; float64 ones on
    the DMMA tiles (symmetric, dual, rect), none on the FFMA tiles."""
    from plssvm_tpu_torch.ops import distance, gram_matmat, gram_matvec, matvec

    op = "matmat" if matmat else "matvec"
    plain = sum(getattr(matvec, n) for n in (
        "sym_plain_calls", "rect_plain_calls", "dual_plain_calls", "sym_matmat_plain_calls",
        "rect_matmat_plain_calls", "dual_matmat_plain_calls", "dist_sym_plain_calls",
        "dist_rect_plain_calls", "dist_dual_plain_calls", "dist_sym_matmat_plain_calls",
        "dist_rect_matmat_plain_calls", "dist_dual_matmat_plain_calls"))
    if kind in ("laplacian", "chi_squared"):
        return (f"distance_{op}_dual",
                [getattr(distance, f"{op}_{w}_launches") for w in ("sym", "dual", "rect")],
                0, plain)
    module = gram_matmat if matmat else gram_matvec
    cores = [module.sym_tc_launches, module.dual_tc_launches, module.rect_tc_launches]
    if dtype == np.float32:
        counts = cores
        other = module.sym_launches + module.dual_launches + module.rect_launches
    else:
        counts = [module.sym_dmma_launches, module.dual_dmma_launches,
                  module.rect_dmma_launches]
        other = (module.sym_launches + module.dual_launches + module.rect_launches
                 + sum(cores))
    return f"gram_{op}_dual", counts, other, plain


def _ring_run(cell, train, test, dtype, epsilon, devices):
    """Fit ``train`` to ``epsilon`` and predict ``test`` of a cell in
    ``dtype`` on ``devices`` (None: one device, cuda:0); the counts of its
    launches from the fit on."""
    import plssvm_tpu_torch as port
    from plssvm_tpu_torch.ops import distance, gram_matmat, gram_matvec

    where = dict(device="cuda") if devices is None else dict(devices=devices)
    svm = port.CSVM(backend="cuda", dtype=dtype, cost=1.0, **where, **cell["params"])
    for module in (gram_matvec, gram_matmat, distance):
        module.reset_counts()
    port.global_tracker.clear()
    t0 = time.perf_counter()
    model = svm.fit(train, epsilon=epsilon)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    values = svm.predict_values(model, test)
    t2 = time.perf_counter()
    iterations = _tracked("cg", "iterations")
    order = (np.asarray(model.class_order()) if values.ndim == 2
             else np.asarray(model.data.mapper.labels()))
    predicted = (order[np.argmax(values, axis=1)] if values.ndim == 2
                 else order[(values > 0).astype(np.intp)])
    kind = cell["params"]["kernel_type"]
    return dict(
        iterations=iterations, values=values, predicted=predicted, fit_s=t1 - t0,
        predict_s=t2 - t1, s_per_it=_tracked("cg", "total_runtime") / 1000 / iterations,
        converged=_tracked("cg", "residuum") <= _tracked("cg", "target_residuum"),
        finite=bool(np.all(np.isfinite(model.alpha))),
        accuracy=float(np.mean(predicted == cell["labels"])),
        counts=_ring_counts(kind, values.ndim == 2, dtype))


def phase_ring(cells):
    """The row-sharded ring on one card: ``CSVM(devices=["cuda:0"] * 4)``
    fits and predicts each cell (binary RBF at config 3's width: A, J, B;
    the 10 Gaussian classes at MNIST width: C, K, D; laplacian on config
    2's files: E, L, F; the 10 histogram classes at config 2's shape with
    chi-squared: G, M, H) in float32 (the default path: A-D, J and K on the
    tensor-core tiles at "f32") and in float64 (A-D, J and K on the DMMA
    tiles, none on the FFMA tiles), each beside the same fit on one
    device.  Gates, in both types: per
    shard and product one symmetric, one dual and (for even P) one
    rows-only launch and per shard one rectangular launch to predict,
    nothing on another tile or the plain versions, epsilon reached; float32
    (the cell's epsilon) the accuracy floor and label agreement with one
    device >= 0.995 (as float32 against float64 elsewhere: the two float32
    solves round apart: 0.9975-1.0000 on an H100); float64 (epsilon 1e-10,
    both solves converged) label agreement >= 0.999, its decision values'
    largest difference logged.  Each one-device run: one symmetric launch
    per product (float64 Gram ones on the DMMA tile), no dual walk, nothing
    on another tile or the plain versions.  Returns the launches per phase
    for the cost ranking: "ring" the float32 dual walks and the distance
    cells' symmetric and rows-only shard products, "ring-f64" the float64
    rings' symmetric, dual and rows-only launches of the fits (DMMA for the
    Gram cells, ``*_f64`` for the distance ones), "ring-one-f64" the
    float64 one-device fits' symmetric launches.  The binary cell is made
    here, the others come from phases 7-9."""
    launches = {"ring": {}, "ring-f64": {}, "ring-one-f64": {}}
    devices = ["cuda:0"] * RING_SHARDS
    steps = (RING_SHARDS - 1) // 2
    for label, cell in {"config3-rbf": _config3_rbf_cell(), **cells}.items():
        kind = cell["params"]["kernel_type"]
        for dtype in (np.float32, np.float64):
            data = cell["make"](dtype)
            epsilon = cell["epsilon"] if dtype == np.float32 else RING_F64_EPSILON
            one = _ring_run(cell, *data, dtype, epsilon, None)
            ring = _ring_run(cell, *data, dtype, epsilon, devices)
            name, counts, other, plain = ring["counts"]
            products = 1 + ring["iterations"] + ring["iterations"] // 50
            agree = float(np.mean(ring["predicted"] == one["predicted"]))
            dvalue = float(np.max(np.abs(ring["values"] - one["values"])))
            type_name = np.dtype(dtype).name
            log("ring", f"{label} {kind} {type_name}, {RING_SHARDS} shards on cuda:0: "
                f"{ring['iterations']} CG iterations at {ring['s_per_it']:.6f} s/iteration "
                f"(one device: {one['iterations']} at {one['s_per_it']:.6f}), reached epsilon "
                f"{epsilon}: {ring['converged']}, fit {ring['fit_s']:.3f} s (one "
                f"device {one['fit_s']:.3f}), predict {len(ring['predicted'])} points "
                f"{ring['predict_s']:.3f} s, accuracy {ring['accuracy']:.4f} (one device "
                f"{one['accuracy']:.4f}), label agreement with one device {agree:.4f}, "
                f"max|d f(x)| {dvalue:.3e}; launches sym / dual / rect {counts}, other tile "
                f"{other}, plain calls {plain}")
            suffix = "" if dtype == np.float32 else "_f64"
            if kind in ("laplacian", "chi_squared"):
                # the fit's symmetric and rows-only shard products, without
                # the predict's rectangular launches; the one-device fit's
                sym, rect = name.replace("dual", "sym"), name.replace("dual", "rect")
                target = launches["ring" if dtype == np.float32 else "ring-f64"]
                target[sym + suffix] = counts[0]
                target[rect + suffix] = counts[2] - RING_SHARDS
                if dtype == np.float64:
                    launches["ring-one-f64"][sym + suffix] = one["counts"][1][0]
            if dtype == np.float32:
                launches["ring"][name] = counts[1]
                if kind not in ("laplacian", "chi_squared"):
                    X = torch.as_tensor(np.asarray(data[0].data), device="cuda")
                    _ring_copy_ms(X, ring["s_per_it"], label)
            else:
                launches["ring-f64"][f"{name}_f64"] = counts[1]
                if kind not in ("laplacian", "chi_squared"):
                    sym = name.replace("dual", "sym_dmma")
                    launches["ring-f64"][sym] = counts[0]
                    launches["ring-one-f64"][sym] = one["counts"][1][0]
                    # the fit's rows-only walks, without the predict's
                    launches["ring-f64"][name.replace("dual", "rect_dmma")] = \
                        counts[2] - RING_SHARDS
                    X = torch.as_tensor(np.asarray(data[0].data), device="cuda")
                    _ring_dmma_copies(X, label)
            _, one_counts, one_other, one_plain = one["counts"]
            one_products = 1 + one["iterations"] + one["iterations"] // 50
            if one_counts[:2] != [one_products, 0] or one_other or one_plain:
                raise AssertionError(f"ring {label} {type_name}: the one-device fit did not "
                                     f"go through its symmetric kernel only: {one_counts}, "
                                     f"other tile {one_other}, plain calls {one_plain}")
            if counts != [RING_SHARDS * products, RING_SHARDS * steps * products,
                          RING_SHARDS * products * (RING_SHARDS % 2 == 0) + RING_SHARDS] \
                    or other or plain:
                raise AssertionError(f"ring {label} {type_name}: did not go through the "
                                     "ring's kernels only")
            if not (ring["converged"] and ring["finite"]):
                raise AssertionError(f"ring {label} {type_name}: did not reach epsilon")
            floor, need = ((cell["floor"], 0.995) if dtype == np.float32 else (0.0, 0.999))
            if ring["accuracy"] < floor or agree < need:
                raise AssertionError(f"ring {label} {type_name}: accuracy {ring['accuracy']} "
                                     f"(floor {floor}), agreement with one device {agree} "
                                     f"(gate {need})")
    return launches


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


def phase_bench_matvec(main_ms):
    """Phase 12: bench_matvec at BENCH_M x BENCH_D for RBF and laplacian;
    every variant's rel_err against the float64 golden within its tier's
    limit, and each kernel launched once for the check and 3 x BENCH_ITERS
    times.  Records kernel_matvec's ms/matvec in the tool's loop (the best
    of its repeats of BENCH_ITERS products) in ``main_ms`` for the cost
    ranking: a single call's time varies with its launch overhead."""
    from plssvm_tpu_torch.ops import distance, gram_matvec, matvec
    from plssvm_tpu_torch.tools import bench_matvec

    gram_matvec.reset_counts()
    distance.reset_counts()
    # rel_err bounds per tier: "highest" (and the plain and distance
    # variants) 1e-5; a tensor-core tier 4 u gamma max|x|^2, the first-order
    # bound of an RBF entry's relative error when both operands round with
    # unit roundoff u (|dK/K| = 2 gamma |dg| <= 4 u gamma |x_i| |x_j|), on
    # the tool's own seeded rows
    Xt = np.random.default_rng(0).normal(size=(BENCH_M, BENCH_D)).astype(np.float32)
    spread = float((Xt.astype(np.float64) ** 2).sum(1).max()) / BENCH_D
    limits = {"kernel_matvec": 4 * UNIT_ROUNDOFF["tf32"] * spread,
              "kernel_matvec_bf16": 4 * UNIT_ROUNDOFF["bf16"] * spread,
              "rect_full": 4 * UNIT_ROUNDOFF["tf32"] * spread}
    for kernel in ("rbf", "laplacian"):
        lines = _run_tool("bench-matvec", bench_matvec.main,
                          [str(BENCH_M), str(BENCH_D), str(BENCH_ITERS), "all", kernel])
        for line in lines[1:]:
            variant = line.split()[0]
            rel = float(line.rsplit("rel_err=", 1)[1])
            limit = limits.get(variant, 1e-5) if kernel == "rbf" else 1e-5
            if not rel <= limit:
                raise AssertionError(f"bench_matvec {kernel}: {line} (limit {limit:.3e})")
            if kernel == "rbf" and variant == "kernel_matvec":
                ms = float(line.split("ms/matvec")[0].split()[-1])
                bound = _sym_bound(BENCH_M, BENCH_D, 1, "gram", 4, 1, "tf32", exp=True)[0]
                _check_share("kernel_matvec", "in bench_matvec's loop", ms, bound)
                main_ms[("kernel_matvec", "bench-matvec")] = (ms, bound)
    log("bench-matvec", "rel_err limits: kernel_matvec and rect_full (TF32) "
        f"{limits['kernel_matvec']:.3e}, kernel_matvec_bf16 "
        f"{limits['kernel_matvec_bf16']:.3e} (4 u gamma max|x|^2), every other 1e-5")
    per_variant = 1 + 3 * BENCH_ITERS
    launches = {
        "kernel_matvec": gram_matvec.kernel_matvec_launches,
        "gram_matvec_sym": gram_matvec.sym_launches,
        "gram_matvec_sym_tc": gram_matvec.sym_tc_launches,
        "gram_matvec_rect": gram_matvec.rect_launches,
        "gram_matvec_rect_tc": gram_matvec.rect_tc_launches,
        "distance_matvec_sym": distance.matvec_sym_launches,
    }
    log("bench-matvec", f"launches {launches}; plain calls: Gram "
        f"{matvec.sym_plain_calls}, distance {matvec.dist_sym_plain_calls}")
    # kernel_matvec at f32 and bf16 (the tensor-core tile) and highest (the
    # FFMA tile) are kernel A's only callers here; rect_full (f32) and
    # rect_full_hi (highest) kernel B's
    if launches != {"kernel_matvec": 3 * per_variant, "gram_matvec_sym": per_variant,
                    "gram_matvec_sym_tc": 2 * per_variant,
                    "gram_matvec_rect": per_variant, "gram_matvec_rect_tc": per_variant,
                    "distance_matvec_sym": per_variant} \
            or matvec.sym_plain_calls != per_variant \
            or matvec.dist_sym_plain_calls != per_variant:
        raise AssertionError("bench_matvec's variants did not launch as expected")
    return {k: launches[k] for k in ("kernel_matvec", "gram_matvec_sym", "gram_matvec_rect")}


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="Drive the port's main path on one GPU.")
    parser.add_argument("--compare-build", metavar="DIR",
                        help="another checkout whose kernels' resources the build phase "
                             "compares with these, and whose float64 distance kernels "
                             "and chi-squared fits the compare phase times beside these")
    args = parser.parse_args(argv)
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

    device_name, smi = run("device", phase_device)
    run("build", phase_build, args.compare_build)
    main_err, main_ms, timing, bounds, g_chi_ms = run("kernels", phase_kernels)
    if args.compare_build:
        run("compare", phase_compare, args.compare_build)
    # per main-path phase, each kernel's launches in that phase's run
    phase_launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        config2_files = _write_config2(tmp)
        phase_launches["e2e"], e2e_predicted = run("e2e", phase_end_to_end, tmp,
                                                   config2_files)
        phase_launches["multiclass"], mc_files = run("multiclass", phase_multiclass_cli,
                                                     tmp)
        phase_launches["bf16"] = run("bf16", phase_bf16, tmp, config2_files,
                                     e2e_predicted, mc_files)
        ring_cells = {}
        phase_launches["laplacian"], ring_cells["laplacian"] = run(
            "laplacian", phase_laplacian_cli, tmp, config2_files)
        phase_launches["chi2-cli"], ring_cells["chi2"] = run("chi2-cli", phase_chi2_cli, tmp)
        phase_launches["config3"] = run("config3", phase_config3_width)
        phase_launches["mnist-width"], ring_cells["mnist-width"] = run(
            "mnist-width", phase_multiclass_width)
        phase_launches["chi2-width"] = run("chi2-width", phase_chi2_width, g_chi_ms)
        phase_launches.update(run("ring", phase_ring, ring_cells))
        del ring_cells
    phase_launches["banded-tool"] = run("banded-tool", phase_banded_tool)
    phase_launches["bench-matvec"] = run("bench-matvec", phase_bench_matvec, main_ms)
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
    # that runs it at the tier its entry names: the bf16 phase's for the
    # tensor-core tiles' "bf16" entries, else the first other phase's
    launches = {}
    for phase, counts in phase_launches.items():
        for k, n in counts.items():
            if phase == "bf16":
                launches[(k, "bf16")] = n
            else:
                launches.setdefault(k, n)
    for tc in ("gram_matvec_sym_tc", "gram_matmat_sym_tc", "gram_matvec_rect_tc",
               "gram_matmat_rect_tc", "gram_matvec_dual", "gram_matmat_dual"):
        launches[(tc, "tf32")] = launches[tc]
    # float64: A-D on the DMMA tiles (phases 4 and 5: A and C their fits, B
    # and D their predicts), J and K on the dual DMMA tile (the ring)
    for f64 in ("gram_matvec_sym_dmma", "gram_matmat_sym_dmma", "gram_matvec_rect_dmma",
                "gram_matmat_rect_dmma"):
        launches[(f64, "f64")] = launches[f64]
    for f64 in ("gram_matvec_dual", "gram_matmat_dual"):
        launches[(f"{f64}_dmma", "f64")] = launches[f"{f64}_f64"]
    # float64 distance kernels: the ring's float64 fits (E-H the shard
    # products, L and M the dual walks)
    for kernel in ("distance_matvec_sym", "distance_matvec_rect", "distance_matmat_sym",
                   "distance_matmat_rect", "distance_matvec_dual", "distance_matmat_dual"):
        launches[(kernel, "f64")] = launches[f"{kernel}_f64"]

    # the distance kernels report the kind their main path ran: laplacian
    # for E and F (phase 8), chi-squared for G and H (phases 9 and 10); the
    # dual walks J-M the ring phase's launches, J and K at "f32" (TF32);
    # kernel_matvec's launches are phase 12's, kernel I's phase 11's; the
    # FFMA tile of A and B at "highest" phase 12's (the bench's "highest"
    # variants) beside their float32 times; the tensor-core tiles one entry
    # per tier; the float64 entries (tier "f64") their float64 launches
    # (A-D phases 4 and 5, J and K the ring) beside their float64 times and
    # bounds.  No single PyTorch call computes any kernel's function
    # (library_ms)
    tiers = {"gram_matvec_sym": "highest", "gram_matvec_rect": "highest",
             "kernel_matvec": "tf32"}
    sources = {
        "gram_matvec_sym": ("gram_matvec.cu", "plssvm_tpu/ops/pallas_matvec.py:430"),
        ("gram_matvec_sym_dmma", "f64"): (
            "gram_dmma.cu", "plssvm_tpu/ops/pallas_matvec.py:430"),
        ("gram_matmat_sym_dmma", "f64"): (
            "gram_dmma.cu", "plssvm_tpu/ops/pallas_matvec.py:812"),
        ("gram_matvec_rect_dmma", "f64"): (
            "gram_dmma.cu", "plssvm_tpu/ops/pallas_matvec.py:1007"),
        ("gram_matmat_rect_dmma", "f64"): (
            "gram_dmma.cu", "plssvm_tpu/ops/pallas_matvec.py:812"),
        ("gram_matvec_dual_dmma", "f64"): (
            "gram_dmma.cu", "plssvm_tpu/ops/pallas_matvec.py:430"),
        ("gram_matmat_dual_dmma", "f64"): (
            "gram_dmma.cu", "plssvm_tpu/ops/pallas_matvec.py:812"),
        ("gram_matvec_sym_tc", "tf32"): ("gram_tc.cuh", "plssvm_tpu/ops/pallas_matvec.py:430"),
        ("gram_matvec_sym_tc", "bf16"): ("gram_tc.cuh", "plssvm_tpu/ops/pallas_matvec.py:430"),
        ("gram_matmat_sym_tc", "tf32"): ("gram_tc.cuh", "plssvm_tpu/ops/pallas_matvec.py:812"),
        ("gram_matmat_sym_tc", "bf16"): ("gram_tc.cuh", "plssvm_tpu/ops/pallas_matvec.py:812"),
        "gram_matvec_rect": ("gram_matvec.cu", "plssvm_tpu/ops/pallas_matvec.py:1007"),
        ("gram_matvec_rect_tc", "tf32"): ("gram_tc.cuh", "plssvm_tpu/ops/pallas_matvec.py:1007"),
        ("gram_matvec_rect_tc", "bf16"): ("gram_tc.cuh", "plssvm_tpu/ops/pallas_matvec.py:1007"),
        ("gram_matmat_rect_tc", "tf32"): ("gram_tc.cuh", "plssvm_tpu/ops/pallas_matvec.py:812"),
        ("gram_matmat_rect_tc", "bf16"): ("gram_tc.cuh", "plssvm_tpu/ops/pallas_matvec.py:812"),
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
        ("gram_matvec_dual", "tf32"): ("gram_tc.cuh", "plssvm_tpu/ops/pallas_matvec.py:430"),
        ("gram_matmat_dual", "tf32"): ("gram_tc.cuh", "plssvm_tpu/ops/pallas_matvec.py:812"),
        ("distance_matvec_dual", "laplacian"): (
            "dual.cu", "plssvm_tpu/ops/pallas_distance.py:226"),
        ("distance_matmat_dual", "chi_squared"): (
            "dual.cu", "plssvm_tpu/ops/pallas_distance.py:412"),
        ("distance_matvec_sym", "f64"): ("distance.cu", "plssvm_tpu/ops/pallas_distance.py:226"),
        ("distance_matvec_rect", "f64"): ("distance.cu", "plssvm_tpu/ops/pallas_distance.py:226"),
        ("distance_matmat_sym", "f64"): ("distance.cu", "plssvm_tpu/ops/pallas_distance.py:412"),
        ("distance_matmat_rect", "f64"): ("distance.cu", "plssvm_tpu/ops/pallas_distance.py:412"),
        ("distance_matvec_dual", "f64"): ("dual.cu", "plssvm_tpu/ops/pallas_distance.py:226"),
        ("distance_matmat_dual", "f64"): ("dual.cu", "plssvm_tpu/ops/pallas_distance.py:412"),
    }
    entries = [
        {
            "name": k if isinstance(k, str) else k[0], "route": "cuda",
            "source": f"plssvm_tpu_torch/csrc/{src}",
            "replaces": replaces,
            "launches": launches[k if isinstance(k, str) or k[1] in ("tf32", "bf16", "f64")
                                 else k[0]],
            "max_abs_err": main_err[k], "ms": timing[k][0],
            "plain_ms": timing[k][1], "bound_ms": bounds[k][0],
            "bound_by": bounds[k][1], "library_ms": None,
            **({"tier": k[1]} if isinstance(k, tuple) and k[1] in ("tf32", "bf16", "f64")
               else {"tier": tiers[k]} if k in tiers else {}),
        }
        for k, (src, replaces) in sources.items()
    ]
    idle = [f"{e['name']} {e.get('tier', '')}" for e in entries if e["launches"] <= 0]
    if idle:
        raise AssertionError(f"kernels of the main path launched no time: {idle}")
    print(smi)
    print(json.dumps({"kernels": entries}))
    # every phase ran on device 0 alone
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name, "count": 1,
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
