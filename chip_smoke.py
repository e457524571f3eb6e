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
   paths' own shapes, at each Gram tier: A and C on the symmetric
   tensor-core tile (``*_sym_tc``), B and D on the rectangular one
   (``*_rect_tc``), at "highest" in three TF32 passes over the split
   operands (held against the full-float32 plain version), at "f32"
   (TF32) and "bf16" held against the plain version on the tier's
   operands, and B and D at "f32" against full float32 within the
   first-order TF32 bound; A-D's FFMA tiles, on no wrapper's path, against
   the full-float32 plain version and timed beside them; in float64, at
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
   tiles), and the two Gram cells also in float32 at
   ``gram_precision="highest"`` (A-D and K on the tensor-core tiles in
   three TF32 passes, J on its matvec walk, nothing on K's FFMA tile), each
   beside one device at the same tier, their float64 agreement logged:
   iterations, s/iteration, the launches of every kernel, epsilon reached,
   the accuracy floor, label agreement >= 0.995 (float32) or 0.999
   (float64), and the ring's operand copies (once per solve, and the
   rows-only walk's per iteration).

The "explicit" phase runs after phase 10 (``phase_explicit``): kernel N
(csrc/kernel_matrix.cu, the explicit solver's kernel matrix for the
distance kernels) against its plain version in both walks, both types and
both storages, then at chi2-width's 59999 x 784 (14.4 GB, timed beside its
bound, sampled rows past INT32_MAX entries and ten columns per entry) and
at the ring's block, and timed beside the plain version at 16384 x 256;
then, with the counts set to 0, ``solver="cg_explicit"`` fits beside the
implicit ones (chi2-width, MNIST width, config 2 and its laplacian files
through ``plssvm-torch-train --solver cg_explicit``, config 2 in
float64), the ring's explicit fit on four shards of cuda:0, and kernel
N's launches.  The "stall" phase follows: ROADMAP Queue 3's float32
chi-squared case, twelve runs with each solver, each run gated to the
first run's iterations per class.  Every phase built to
launch an implicit kernel pins ``solver="cg_implicit"`` and logs what
``automatic`` would resolve to at its shape.

The "determinism" phase runs right after phase 7 (``phase_determinism``):
every walk that sums across blocks (csrc/fixed_sum.cuh: A-M's tiles and
walks, their FFMA tiles, I) called twice at the main path's shapes in
float32 at each tier and in float64 must give equal bits; two config-2
fits through ``plssvm-torch-train`` must write the same model below its
creation-time line, two MNIST-width fits the same alphas; and the
reduction alone (``fixed_sum``) is held against its plain version and timed
beside ``torch.sum``, its bound and its launches (config 2's fit and
predict) in the kernels line.  The "tools" phase runs after "multihost"
(``phase_tools``): each tool of ROADMAP item 11 at a small size on the
card, the tracker's YAML of ``performance_analysis`` through the port's
parser, and ``plssvm-torch-train --profile`` on config 2's fit, whose
trace must name ``gram_tc_sym_kernel`` and whose model must be the one the
fit without it writes.  After the last phase every workspace the
fixed-order sums asked for must be at most 1 GiB.

The "oao" phase runs after phase 7 (``phase_oao``): kernel O (the
batched pair-machine matvec of one-vs-one training: the Gram kinds on the
tensor-core walks of csrc/pairs_tc.cu at "f32" / "bf16" and in float64,
the FFMA walk of csrc/pairs.cu at "highest" and for the distance kinds)
against its plain version for every kind at every tier in float32 and
float64 on ragged stacks of 3 and 45 machines, twice on the same input
(bit for bit), a machine alone against the same machine inside the stack
(bit for bit); then, with the counts set to 0 before each drive, phase 5's
10 Gaussian classes through ``plssvm-torch-train --classification oao``
(``automatic`` takes the batched pairs CG, O once per block iteration) and
``plssvm-torch-predict``, the sequential strategy beside it in float32 and
float64, batched fits at "bf16" and "highest", phase 9's histogram classes
(chi-squared: batched on O, sequential on kernel N; O held per entry of K
in float32 and float64), phase 7's MNIST-width classes (batched and
sequential fit seconds, O timed at each tier beside its bound and the
per-machine cuBLAS Gram products at that stack), the batched fit with its
machines split over ``devices=["cuda:0"] * 4`` against one device, and
LS-SVR on Friedman #1 (10000 x 10) through ``plssvm-torch-train -s
epsilon_svr`` and ``plssvm-torch-predict`` (R^2, float32 against float64).

The "parse" phase runs before phase 4: the native parser
(``plssvm_tpu_torch/native``, built with g++) against the NumPy path on
phases 4 and 5's files and a model of config 2's size, bit for bit and
byte for byte, each path timed; then phase 4's CLI runs with the NumPy
I/O, native, native, NumPy.  Every CLI run (phases 4, 5, 8, 9, bf16)
logs its file I/O seconds beside the rest and fails unless the native
library carried its three parses and one model write.

The "highest" phase runs right after phase 7 (``phase_highest``): phase
4's config 2 files through ``plssvm-torch-train --gram_precision highest
--solver cg_implicit`` and predicted at "highest", and phase 7's 10
classes at MNIST width through ``CSVM(gram_precision="highest")``: A-D on
the tensor-core tiles in three TF32 passes (no FFMA-tile launch), the
accuracy floors, labels against a float64 fit on >= 0.995, s/iteration
beside each cell's TF32 fit.

The "bf16" phase runs right after phase 5, on the files of phases 4 and
5: both trained through ``plssvm-torch-train --gram_precision bf16`` and
predicted through ``CSVM(gram_precision="bf16")`` (kernels A-D on the
tensor-core tiles with bf16 operands), accuracy floors as
phases 4 and 5, label agreement with the "f32" runs logged.  Phases 8 and
9 follow, then the "extras" phase (``phase_extras``: warm start, class
weights through the CLIs, Jacobi and ROADMAP Queue 3's chi-squared case,
checkpoint/resume on one device and on the ring, the debug guard) and
the "host-clis" phase (``plssvm-torch-scale`` and
``plssvm-torch-generate-data``, timed), then 6, 7, 10 and 13 while phase
8 and 9's files exist, then phases 11 and 12.

After the ring, the host modules around the fits: "one-class",
"probability" and "robust" (``phase_one_class``, ``phase_probability``,
``phase_robust``), then "compact" (``phase_compact``: Nystroem fits at MNIST
width in float32 and float64 and on four shards of cuda:0, chi-squared at
chi2-width on kernel N, ``plssvm-torch-train --max_sv`` on config 2's and
the 10-class files, ``--nystroem --streaming`` against the in-memory fit)
and "sklearn" (``phase_sklearn``: SVC one-vs-all, one-vs-one and with
probabilities, SVR, OneClassSVM and the compact SVCs, each against the
CSVM-level call; sklearn itself never imported), each with its launches
counted from 0.  Then "multihost" (``phase_multihost``: multi-process fits
and predicts on ``torch.distributed``, every rank a process of
``plssvm_tpu_torch.tools.multihost_rehearsal`` parsing its window of the
files; gloo ranks on cuda:0, since NCCL puts no two ranks on one card:
W = 4 at MNIST width in both types, W = 3 config 3 RBF through both
CLIs with ``--multihost`` and the laplacian on config 2's files, W = 2
chi-squared through ``automatic``, one-class and Nystroem, each against
the in-process ring of as many shards; one NCCL rank in this process
against ``CSVM.fit``), its launches counted per rank;
``--multihost-only`` runs it alone after the cells it reads.

Phase 3 also holds kernels E-H (laplacian / chi-squared matvecs and block
matmats, csrc/distance.cu) against their plain versions on ragged shapes
with non-negative, zero-rich data and at phases 8-10's shapes, and times
them there and, beside kernel A, at m = 16384, d = 256; kernel I (the
banded laplacian matvec, csrc/banded.cu) against its plain version and
kernel E on ragged shapes and at phase 11's shape, where it is timed
beside kernel E; and ``kernel_matvec`` against kernel A and its plain
version, timed at kernel A's shape; and kernels J-M (the ring's dual
walks: csrc/dual.cu, J and K at "f32" and "bf16" and K at "highest" (three
TF32 passes over the split operands) on the dual tensor-core tile of
csrc/gram_tc.cuh, whose blocks per SM it logs for each tier, and in
float64 on the dual DMMA tile of csrc/gram_dmma.cu), both outputs, against
their plain versions on ragged mr != mc blocks in float32 and float64, J
and K at each Gram tier, L and M per entry of K in float32 chi-squared,
then timed at the ring phase's block shapes (J and K at each tier; K at
"highest" beside its FFMA tile, on no wrapper's path, and the full-float32
``torch.matmul(Xr, Xc.T)`` yardstick, and again at 32768^2 x 512 with 10
classes), with the cost of K and M's column atomics logged; and in float64
kernels A and C on the symmetric DMMA tile, B and D on the rect one and J
and K on the dual one (csrc/gram_dmma.cu, the three tiles' blocks per SM
logged) against their plain versions on ragged shapes at every tier, A and
C timed at 32768 x 512, 49999 x 500 and 59999 x 784 (C = 10), both bounds
and DGEMM beside, B and D at 32768 x 512 beside both bounds and DGEMM, J
and K at the ring's blocks beside both bounds, and every float64 kernel at
the shapes the float64 fits of phases 4, 5 and 13 give it (the ring's
rows-only walks B and D included), A-D, J and K held against their plain
versions there too; and E-H, L and M in float64 (chi-squared on the
divide-free quotient, the timed rows checked to lie within its range on
the host): L and M at the ring's blocks, E-H at the ring's shard shapes
and at its one-device fits' shapes, where E-H are also held per entry of
the chi-squared K against long double, each beside its plain version, and
E-H at m = 8192 and 16384, d = 256, G there also on rows scaled out of the
quotient's range. Beside every kernel's time it computes the bound: the
least time the card could take for the function on these inputs (see
``_bound``), and fails if a kernel measures faster than that (a wrong
bound or a wrong timing). At phases 9 and 10's shapes it holds kernels E-H
in float32 chi-squared per entry of K against the plain version in float64
(one-hot right-hand sides pick columns of K) and logs each one's error
beside the float32 plain version's and its share of the bound. The ring's
distance shard products, E-H in float32 and float64, are timed at the
ring's shapes for the cost ranking too.

``python3 chip_smoke.py --compare-build DIR`` also builds the kernels of
another checkout (a parent commit unpacked with ``git archive``) in the
build phase and logs, for every kernel instantiation the two share,
whether its registers, spills and shared memory are the same, and which
instantiations only one of them has; then, right after the kernels
phase, it times float64 E-H, L (float32 and float64, laplacian and
chi-squared) and M, the rows-only F beside L, J and K at "highest",
float32 G and kernel N at phase 10's shape, N laplacian at config 2's,
the float64 chi-squared and laplacian fits on one device and on the ring
and the MNIST-width ring at "highest" in both checkouts, each in a
process of its own (other, here, here, other), and logs the pairs beside
the bounds (``phase_compare``, ``_compare_times``).

The build phase fails unless the matvec walk of J and L
(``matvec_dual_kernel``, csrc/dual.cu) compiled once per float32 kind and
per float64 distance kind without spilling, and the split dual tile once
per Gram kind without spilling; the kernels phase logs its
blocks per SM (its persistent grid) and, at the ring's block, L at C = 1
beside the rows-only F on the same block.

Before the last line it prints the card's name and power limit as
nvidia-smi reports them, and one JSON object describing each kernel (the
Gram entries with their tier, the tensor-core tile once per tier); the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the repository around it, the script fails and prints no result.
"""

import contextlib
import io
import json
import math
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
#: phases 10 and explicit train chi2-width to epsilon 1e-7 (44-48 block
#: iterations): there two float32 fits, implicit or explicit, agree on
#: 0.997 of the labels and each with the float64 fit at 1e-10 on 0.996
#: (``--chi2-width-agreement`` on an H100 80GB HBM3); at 1e-8 a float32
#: fit runs to any cap
CHI_WIDTH_EPSILON = 1e-7
#: the cap on the extras phase's re-run of ROADMAP Queue 3's case (phase
#: 9's classes in float32 to epsilon 1e-8 with Jacobi): unpreconditioned, one
#: class ran 4343 iterations; ~10 ms an iteration keeps the cap under 30 s
JACOBI_CHI2_MAX_ITER = 2500
#: the rough fit that the extras phase warm-starts from: at 1e-4 config 2
#: stops after one iteration, and a CG restarted from one step saves at most
#: one of the cold fit's 20-22 (TF32 sums vary from run to run), so "fewer
#: iterations" held only by chance; from 1e-6 the restart has half the work
#: behind it
WARM_ROUGH_EPSILON = 1e-6
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
#: per tensor-core tier: the Gram product's peak rate and the operand's
#: bytes per feature.  The split tier ("highest") is three TF32 passes
#: over two float32 parts: a third of the TF32 rate, 2 x 4 bytes
TC_TIERS = {"tf32": (TF32_FLOP_PER_S, 4), "bf16": (BF16_FLOP_PER_S, 2),
            "tf32x3": (TF32_FLOP_PER_S / 3, 8)}
#: the Gram tiers of kernels A-D on the tensor cores, by gram_precision
TIER_OF = {"f32": "tf32", "bf16": "bf16", "highest": "tf32x3"}
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


#: kernel_resources() names of the matvec walk's instantiations (csrc/dual.cu
#: matvec_dual_kernel): J at "highest" in float32, L in both types
WALK_INSTANTIATIONS = (
    [f"gram_matvec_dual f32 {k}" for k in ("poly", "rbf", "sigmoid")]
    + [f"distance_matvec_dual {t} {k}" for t in ("f32", "f64")
       for k in ("laplacian", "chi_squared")])


#: kernel_resources() names of kernel O's FFMA walk (csrc/pairs.cu), per
#: type and kind, and of its reduction, per type and tile edge
PAIRS_FFMA_INSTANTIATIONS = (
    [f"pairs_matvec {t} {k}" for t in ("f32", "f64")
     for k in ("poly", "rbf", "sigmoid", "laplacian", "chi_squared")]
    + ["pairs_reduce f32 edge 128", "pairs_reduce f32 edge 64", "pairs_reduce f64 edge 64"])
#: the most spill bytes an instantiation of kernel O's FFMA walk may take
PAIRS_FFMA_SPILL_BYTES = 128


#: the kernels line's entries of kernels on no wrapper's path: A and B's
#: FFMA tiles, timed beside the split tier that replaced them at "highest"
OFF_PATH = ("gram_matvec_sym", "gram_matvec_rect")


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
    for tile in ("gram_dmma_sym", "gram_dmma_dual", "gram_dmma_rect", "pairs_dmma"):
        dmma = {n: r for n, r in mine.items() if n.startswith(tile + " ")}
        compiled = len(re.findall(rf"Compiling entry function '\w*{tile}_kernel", ptxas))
        if (len(dmma) != 3 or compiled != 3
                or any(r.get("spill_bytes", 0) > 64 or r.get("registers", 256) > 255
                       for r in dmma.values())):
            raise AssertionError(f"{tile}'s instantiations ({compiled} compiled): {dmma}")
        log("build", f"{tile}_kernel compiled {compiled} times: " + ", ".join(
            f"{n.split()[-1]} {r['registers']} registers, {r['spill_bytes']} spill bytes, "
            f"{r['smem_bytes']} B static shared memory" for n, r in sorted(dmma.items())))
    # kernel O's tensor-core walk: one instantiation per tier and Gram kind,
    # within the two blocks an SM that __launch_bounds__ asks for
    walk_tc = {n: r for n, r in mine.items() if n.startswith("pairs_tc ")}
    compiled = len(re.findall(r"Compiling entry function '\w*pairs_tc_kernel", ptxas))
    if (len(walk_tc) != 6 or compiled != 6
            or any(r.get("spill_bytes", 0) > 64 or r.get("registers", 256) > 128
                   for r in walk_tc.values())):
        raise AssertionError(f"pairs_tc's instantiations ({compiled} compiled): {walk_tc}")
    if "C7515" in ptxas:
        raise AssertionError("ptxas serialised a tensor-core product (C7515)")
    # the split tier ("highest", three TF32 passes) of the sym and rect
    # tiles: one instantiation per Gram kind, within the one block an SM of
    # their __launch_bounds__ (its 192 KB ring), spilling nothing
    split = {n: r for n, r in mine.items()
             if n.split()[0] in ("gram_tc_sym", "gram_tc_rect") and n.split()[1] == "tf32x3"}
    if len(split) != 6 or any(r.get("spill_bytes", 0) > 0 or r.get("registers", 256) > 255
                              for r in split.values()):
        raise AssertionError(f"the split tiles' instantiations: {split}")
    log("build", "the split tiles (tf32x3): " + ", ".join(
        f"{n} {r['registers']} registers, {r.get('spill_bytes', 0)} spill bytes"
        for n, r in sorted(split.items())))
    # K at "highest" on the split dual tile: one instantiation per Gram
    # kind, spilling nothing
    split_dual = {n: r for n, r in mine.items() if n.startswith("gram_tc_dual tf32x3 ")}
    if len(split_dual) != 3 or any(r.get("spill_bytes", 0) > 0 or r.get("registers", 256) > 255
                                   for r in split_dual.values()):
        raise AssertionError(f"the split dual tile's instantiations: {split_dual}")
    log("build", "the split dual tile (tf32x3): " + ", ".join(
        f"{n.split()[-1]} {r['registers']} registers, {r.get('spill_bytes', 0)} spill bytes, "
        f"{r['smem_bytes']} B static shared memory" for n, r in sorted(split_dual.items())))
    # kernel O's FFMA walk: one instantiation per type and kind, within the
    # registers of the blocks an SM its __launch_bounds__ asks for (two: 128
    # registers, where the float Gram and laplacian tiles spill 48-84 bytes
    # on an H100 with nvcc 12.9; one for double chi-squared) and spilling no
    # more than PAIRS_FFMA_SPILL_BYTES; its reduction one per type and tile
    # edge, none spilling
    ffma = {n: r for n, r in mine.items() if n.split()[0] in ("pairs_matvec", "pairs_reduce")}
    if sorted(ffma) != sorted(PAIRS_FFMA_INSTANTIATIONS) or any(
            r.get("spill_bytes", 0) > (PAIRS_FFMA_SPILL_BYTES if n.startswith("pairs_matvec")
                                       else 0)
            or r.get("registers", 256) > (255 if n == "pairs_matvec f64 chi_squared" else 128)
            for n, r in ffma.items()):
        raise AssertionError(f"kernel O's FFMA walk's instantiations: {ffma}")
    log("build", "kernel O's FFMA walk and reduction: " + ", ".join(
        f"{n.split(' ', 1)[1]} {r['registers']} registers, {r.get('spill_bytes', 0)} spill "
        f"bytes" for n, r in sorted(ffma.items())))
    # the matvec walk (J at "highest", L): one instantiation per float32
    # kind and per float64 distance kind, none spilling
    walk = {n: r for n, r in mine.items()
            if n.split()[0] in ("gram_matvec_dual", "distance_matvec_dual")}
    if sorted(walk) != sorted(WALK_INSTANTIATIONS) or any(
            r.get("spill_bytes", 0) for r in walk.values()):
        raise AssertionError(f"the matvec walk's instantiations: {walk}")
    log("build", "matvec_dual_kernel (the walk of J and L): " + ", ".join(
        f"{n.split(' ', 1)[1]} {r['registers']} registers, {r.get('spill_bytes', 0)} spill "
        f"bytes" for n, r in sorted(walk.items())))
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


def _ffma(op):
    """Kernels A-D and K's FFMA tile (``gram_matvec.gram_ffma``, on no
    wrapper's path) called as its wrapper is: ``(X, sq, v)``, ``(P, S,
    sq_p, sq_s, a)`` or, for K ("matmat_dual"), ``(Xr, Xc, sq_r, sq_c, V_c,
    V_r)``."""
    from plssvm_tpu_torch.ops import gram_matvec

    n = 2 if op.endswith(("rect", "dual")) else 1

    def kernel(*args, precision="highest", **kw):
        weights = args[2 * n:] if op.endswith("dual") else args[2 * n]
        return gram_matvec.gram_ffma(op, args[:n], args[n:2 * n], weights, **kw)

    return kernel


def _pairs(v, precision="highest", ffma=False):
    """(name, kernel, plain) of the symmetric and the rectangular kernel for
    a right-hand side v (m,) (kernels A, B) or V (m, C) (kernels C, D) at
    the Gram tier ``precision``.  On float32 both kernels are the
    tensor-core tiles at every tier (``*_sym_tc``, ``*_rect_tc``; "highest"
    three TF32 passes), held against the plain version on the tier's
    operands ("highest": the full-float32 plain version); with ``ffma``
    the FFMA tiles instead (``*_sym``, ``*_rect``, full float32, on no
    wrapper's path); in float64 both are DMMA tiles (``*_sym_dmma``,
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
    if ffma:
        sym, rect = _ffma(base[5:] + "_sym"), _ffma(base[5:] + "_rect")
    tile = "_dmma" if v.dtype == torch.float64 else "" if ffma else "_tc"
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


def _compare(kind, coef0, X, P, v, precision="highest", rect=True, ffma=False):
    """max|kernel - plain| and max|plain| for kernels A and B (v (m,)) or
    C and D (v (m, C)) at the Gram tier ``precision`` (``_pairs``; with
    ``ffma`` their FFMA tiles); the rectangular kernel only when ``rect``."""
    kw = dict(kind=kind, gamma=1.0 / X.shape[1], coef0=coef0, degree=3)
    sq, sq_p = (X * X).sum(-1), (P * P).sum(-1)
    (sym_name, sym, sym_plain), (rect_name, rect_k, rect_plain) = _pairs(v, precision, ffma)
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


def _on_operands(kernel, name, args, precision):
    """``kernel``, a dual walk, on the pair of ``tier_operand`` copies of Xr
    and Xc (``args[:2]``) that the ring makes once per solve, where the walk
    takes them: the tensor-core tile, J and K on float32 at "f32" / "bf16",
    K also at "highest"; else ``kernel`` itself."""
    import functools

    from plssvm_tpu_torch.ops import gram_matvec

    Xr, Xc = args[0], args[1]
    if (not name.startswith("gram") or Xr.dtype != torch.float32
            or (name == "gram_matvec_dual" and precision not in ("f32", "bf16"))):
        return kernel
    return functools.partial(kernel, operand=(gram_matvec.tier_operand(Xr, precision),
                                              gram_matvec.tier_operand(Xc, precision)))


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
    adds to: K on float32 at every tier and J at "f32" / "bf16" the
    tensor-core tile's ``dual_tc_launches`` (K at "highest" in three TF32
    passes), J at "highest" its matvec walk's ``dual_launches``, in float64
    at every tier the dual DMMA tile's ``dual_dmma_launches``."""
    from plssvm_tpu_torch.ops import distance, gram_matmat, gram_matvec

    if name.startswith("distance"):
        return distance, name.split("_", 1)[1].replace("dual", "dual_launches")
    module = gram_matvec if name == "gram_matvec_dual" else gram_matmat
    if dtype == torch.float64:
        return module, "dual_dmma_launches"
    walk = name == "gram_matvec_dual" and precision not in ("f32", "bf16")
    return module, "dual_launches" if walk else "dual_tc_launches"


#: the dual tensor-core tile's tiers: (name, the query's tier code, the
#: blocks an SM its design needs: two at the one-pass tiers, so that one
#: block's epilogue overlaps the other's products; one at the split tier,
#: whose three 64 KB stages fill the SM)
DUAL_TC_TIERS = (("tf32", 0, 2), ("bf16", 1, 2), ("tf32x3", 2, 1))


def _dual_blocks_per_sm():
    """The dual tensor-core tile's blocks per SM for every tier and Gram
    kind, logged; raises below the blocks each tier's design needs."""
    import ctypes

    from plssvm_tpu_torch.ops import _build

    lib = _build.load()
    found, short = {}, []
    for tier, code, need in DUAL_TC_TIERS:
        for kind, name in ((1, "poly"), (2, "rbf"), (3, "sigmoid")):
            blocks = ctypes.c_int(0)
            err = lib.plssvm_gram_dual_tc_blocks_per_sm(code, kind, ctypes.byref(blocks))
            if err != 0:
                raise AssertionError(f"gram_tc_dual {tier} {name}: occupancy query failed "
                                     f"({lib.plssvm_cuda_error_string(err).decode()})")
            found[f"{tier} {name}"] = blocks.value
            if blocks.value < need:
                short.append(f"{tier} {name} {blocks.value} (needs {need})")
    log("kernels", "gram_tc_dual blocks per SM: " + ", ".join(
        f"{k} {v}" for k, v in found.items()))
    if short:
        raise AssertionError(f"the dual tensor-core tile holds too few blocks an SM: {short}")


def _walk_blocks_per_sm():
    """The matvec walk's (J at "highest", L) blocks per SM for each type and
    kind, logged beside the grid it launches at the ring's blocks; raises
    where the query fails or finds none."""
    import ctypes

    from plssvm_tpu_torch.ops import _build

    lib = _build.load()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    found = {}
    for f64, kinds in ((0, ((1, "poly"), (2, "rbf"), (3, "sigmoid"), (4, "laplacian"),
                            (5, "chi_squared"))),
                       (1, ((4, "laplacian"), (5, "chi_squared")))):
        for kind, name in kinds:
            blocks = ctypes.c_int(0)
            err = lib.plssvm_dual_walk_blocks_per_sm(f64, kind, ctypes.byref(blocks))
            if err != 0 or blocks.value < 1:
                raise AssertionError(f"the matvec walk {name} f{64 if f64 else 32}: occupancy "
                                     f"query failed ({err}, {blocks.value} blocks)")
            found[f"{'f64' if f64 else 'f32'} {name}"] = blocks.value
    log("kernels", f"matvec walk (J at highest, L) blocks per SM on {sms} SMs, the persistent "
        "grid SMs x blocks: " + ", ".join(f"{k} {v} ({v * sms} blocks)"
                                           for k, v in found.items()))


def _walk_epilogue_split(args, kw, label):
    """Kernel L at C = 1 beside the rows-only walk F on the same block, each
    per call and back to back (``_back_to_back_ms``): F evaluates the same
    pairs without the column sums, so the difference bounds what the dual
    walk's second output costs; logged."""
    from plssvm_tpu_torch.ops import distance

    Xr, Xc, v_c, v_r = args
    times = {}
    for name, fn in (("L", lambda: distance.distance_matvec_dual(*args, **kw)),
                     ("F", lambda: distance.distance_matvec_rect(Xr, Xc, v_c, **kw))):
        times[name] = (_median_ms(fn), _back_to_back_ms(fn))
    (dual, dual_b2b), (rows, rows_b2b) = times["L"], times["F"]
    log("kernels", f"epilogue at C=1, L {label}: the dual walk {dual:.4f} ms a call, "
        f"{dual_b2b:.4f} back to back; the rows-only walk F on the same block {rows:.4f} / "
        f"{rows_b2b:.4f}; the column sums and the walks' other differences "
        f"{dual_b2b - rows_b2b:+.4f} ms back to back ({(dual_b2b - rows_b2b) / dual_b2b:+.1%} "
        f"of L); the host's share of a call {dual - dual_b2b:.4f} ms")


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
    _walk_blocks_per_sm()
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
        # the tensor-core tile on the operand pair the ring makes once
        kernel = _on_operands(kernel, name, args, tier)
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
        if name == "distance_matvec_dual":
            _walk_epilogue_split(args, kw, label)
        if tier:
            _time_dual_tiers(name, args, kw, mr, d, columns, base, timing[key][0],
                             (main_err, main_ms, timing, bounds))
    _time_split_k(gen)
    lap = torch.randn(5000, 200, generator=gen, dtype=torch.float64).to("cuda", torch.float32)
    _ring_distance_shards(gen, main_err, main_ms, lap, hist, chi2_gamma, "ring")

    # the atomics of the column sums: K and M issue one per column, class
    # and tile where the rectangular D and H (same tile, row sums only)
    # issue none for columns; each at 10 classes against 1 class on the
    # same block, the dual walk beside the rectangular one, K on the
    # tensor-core tiles at "highest" (three TF32 passes) and "f32"
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


def _time_dual_tiers(name, args, kw, mr, d, columns, label, tf32_ms, tables):
    """J or K at a ring block (``label`` its shape) beside its "f32" time
    ``tf32_ms``, the tensor-core tile on the operand pair the ring makes
    once (``_on_operands``): at "bf16" against the plain version
    at "bf16" and the bf16 bound, logged; at "highest" (the ring-highest
    cells' tier) against the full-float32 plain version, K on the split
    dual tile (three TF32 passes) beside the split bound and, from the same
    run, its FFMA tile (``_ffma``, on no wrapper's path, held against the
    same plain version) beside the FFMA bound and the full-float32
    ``torch.matmul(Xr, Xc.T)`` yardstick, J on its matvec walk beside the
    FFMA bound.  The "highest" kernel goes into ``tables`` (main_err,
    main_ms, timing, bounds) under (name, "tf32x3") for K, (name,
    "highest") for J, and (name, "ring-highest") for the cost ranking."""
    main_err, main_ms, timing, bounds = tables
    exp = str(kw["kind"]) == "rbf"
    work = float(mr) * mr * d
    kernel, plain = _dual_pair(name, "bf16")
    kernel = _on_operands(kernel, name, args, "bf16")
    bf16_ms = _time_pair(name, kernel, plain, args, kw, work, f"{label} bf16",
                         unit="Tpair-feature/s", counted="mr mc d")[0]
    _log_bound(name, f"{label} bf16", bf16_ms,
               _dual_bound(mr, mr, d, columns, "gram", 4, 1, "bf16", exp=exp))
    kernel, plain = _dual_pair(name, "highest")
    kernel = _on_operands(kernel, name, args, "highest")
    split = name == "gram_matmat_dual"
    key = (name, "tf32x3" if split else "highest")
    want = plain(*args, **kw)
    main_err[key] = _check_dual(f"{label} highest", kernel(*args, **kw), want)[1]
    timing[key] = _time_pair(name, kernel, plain, args, kw, work, f"{label} highest",
                             unit="Tpair-feature/s", counted="mr mc d")
    ffma = _dual_bound(mr, mr, d, columns, "gram", 4, 1)
    bounds[key] = _dual_bound(mr, mr, d, columns, "gram", 4, 1, "tf32x3", exp=exp) \
        if split else ffma
    main_ms[(name, "ring-highest")] = (timing[key][0], bounds[key][0])
    tile = "the split dual tile" if split else "the matvec walk"
    _log_bound(name, f"{label} highest ({tile})", timing[key][0], bounds[key])
    if split:
        ffma_tile = _ffma("matmat_dual")
        ffma_err = _check_dual(f"{label} highest, the FFMA tile", ffma_tile(*args, **kw),
                               want)[0]
        ffma_ms = _median_ms(lambda: ffma_tile(*args, **kw), 5, 1)
        _log_bound(name, f"{label} highest, the FFMA tile (on no wrapper's path)", ffma_ms,
                   ffma)
        torch.backends.cuda.matmul.allow_tf32 = False
        _yardstick(f"torch.matmul(Xr, Xc.T) {mr}x{mr}x{d} f32", lambda: torch.matmul(
            args[0], args[1].T))
        log("kernels", f"{name} {label} highest: the split dual tile {timing[key][0]:.3f} ms, "
            f"max|err|/max|plain| {main_err[key] / float(want[0].abs().max()):.3e}; the FFMA "
            f"tile {ffma_ms:.3f} ms ({ffma_ms / timing[key][0]:.2f}x), {ffma_err:.3e}")
    log("kernels", f"{name} {mr}x{mr}x{d}: the tensor-core tile at f32 (TF32) "
        f"{tf32_ms:.3f} ms, at bf16 {bf16_ms:.3f} ms; at highest {tile} "
        f"{timing[key][0]:.3f} ms ({timing[key][0] / tf32_ms:.2f}x the TF32 time)")


#: K at "highest" timed at the kernels phase's own shape too: the square
#: that B and D are timed over, 32768^2 x 512, with 10 classes
K_SPLIT_TIMING = (32768, 512, 10)


def _time_split_k(gen):
    """Kernel K at "highest" on the split dual tile at ``K_SPLIT_TIMING``
    (on the operand pair made once) against the full-float32 plain version
    (the 1e-4 gate) and beside its FFMA tile from the same run, each beside
    its bound; logged."""
    from plssvm_tpu_torch.parameter import KernelFunctionType as K

    m, d, columns = K_SPLIT_TIMING
    X = torch.randn(2 * m, d, generator=gen, dtype=torch.float64).to("cuda", torch.float32)
    Xr, Xc = X[:m].contiguous(), X[m:].contiguous()
    del X
    V_c, V_r = (torch.randn(m, columns, generator=gen, dtype=torch.float64).to(
        "cuda", torch.float32) for _ in range(2))
    args = (Xr, Xc, (Xr * Xr).sum(-1), (Xc * Xc).sum(-1), V_c, V_r)
    kw = dict(kind=K.RBF, gamma=1.0 / d, coef0=0.0, degree=3)
    kernel, plain = _dual_pair("gram_matmat_dual", "highest")
    kernel = _on_operands(kernel, "gram_matmat_dual", args, "highest")
    label = f"{m}x{m}x{d} f32 rbf C={columns} highest"
    rel, _ = _check_dual(label, kernel(*args, **kw), plain(*args, **kw))
    ffma_tile = _ffma("matmat_dual")
    split_ms = _median_ms(lambda: kernel(*args, **kw), 5, 1)
    ffma_ms = _median_ms(lambda: ffma_tile(*args, **kw), 5, 1)
    _log_bound("gram_matmat_dual", f"{label} (the split dual tile)", split_ms,
               _dual_bound(m, m, d, columns, "gram", 4, 1, "tf32x3", exp=True))
    _log_bound("gram_matmat_dual", f"{label}, the FFMA tile (on no wrapper's path)", ffma_ms,
               _dual_bound(m, m, d, columns, "gram", 4, 1))
    log("kernels", f"gram_matmat_dual {label}: split {split_ms:.3f} ms (max|err|/max|plain| "
        f"{rel:.3e}), FFMA tile {ffma_ms:.3f} ms ({ffma_ms / split_ms:.2f}x)")


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


def _back_to_back_ms(fn, calls=20, warmup=2):
    """ms per call of ``calls`` calls made back to back: the host enqueues
    the next call while the card runs this one, so a kernel of a fraction
    of a millisecond is timed without the wrapper's host work (its
    launches, the zeroed outputs' fills included)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / calls


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
             for tier in ("f32", "bf16", "highest")}
    log("kernels", f"operand copy {label}: f32 (TF32-rounded) {times['f32']:.3f} ms, "
        f"bf16 {times['bf16']:.3f} ms, highest (the split stack) {times['highest']:.3f} ms")


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
            # at "highest" float32 also the FFMA tiles, on no wrapper's path
            ffma = (False, True) if precision == "highest" and X.dtype == torch.float32 \
                else (False,)
            for kind, coef0 in kinds:
                for tile in ffma:
                    for name, (err, scale) in _compare(kind, coef0, X, P, v, precision,
                                                       ffma=tile).items():
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
    # e2e and config3, "bf16" in the bf16 phase, "highest" (three TF32
    # passes) in the highest phase; the FFMA tile logged beside
    main_err, main_ms = {}, {}
    X, P, v = _operands(9999, 200, torch.float32, gen, n_points=2000)
    rbf = dict(kind=K.RBF, gamma=1.0 / 200, coef0=0.0, degree=3)
    sq = (X * X).sum(-1)
    main_err["gram_matvec_sym"] = _compare(K.RBF, 0.0, X, P, v, rect=False,
                                           ffma=True)["gram_matvec_sym"][0]
    for tier, phase in (("f32", "e2e"), ("bf16", "bf16"), ("highest", "highest")):
        key = ("gram_matvec_sym_tc", TIER_OF[tier])
        main_err[key] = _compare(K.RBF, 0.0, X, P, v, tier, rect=False)["gram_matvec_sym_tc"][0]
        op = gram_matvec.tier_operand(X, tier)  # the solve makes it once
        _time_at_main_shape(main_ms, "gram_matvec_sym_tc", phase,
                            lambda: gram_matvec.gram_matvec_sym(X, sq, v, precision=tier,
                                                                operand=op, **rbf),
                            _sym_bound(9999, 200, 1, "gram", 4, 1, TIER_OF[tier], exp=True),
                            f"9999x200 rbf {tier}")
    _time_at_main_shape(main_ms, "gram_matvec_sym", None,
                        lambda: _ffma("matvec_sym")(X, sq, v, **rbf),
                        _sym_bound(9999, 200, 1, "gram", 4, 1), "9999x200 rbf FFMA tile")
    X, P, v = _operands(10000, 200, torch.float32, gen, n_points=2000)
    sq, sq_p = (X * X).sum(-1), (P * P).sum(-1)
    main_err["gram_matvec_rect"] = _compare(K.RBF, 0.0, X, P, v, ffma=True)["gram_matvec_rect"][0]
    for tier, phase in (("f32", "e2e"), ("bf16", "bf16"), ("highest", "highest")):
        key = ("gram_matvec_rect_tc", TIER_OF[tier])
        main_err[key] = _compare(K.RBF, 0.0, X, P, v, tier)["gram_matvec_rect_tc"][0]
        _time_at_main_shape(main_ms, "gram_matvec_rect_tc", phase,
                            lambda: gram_matvec.gram_matvec_rect(P, X, sq_p, sq, v,
                                                                 precision=tier, **rbf),
                            _rect_bound(2000, 10000, 200, 1, "gram", 4, 1, TIER_OF[tier],
                                        exp=True),
                            f"2000x10000x200 rbf {tier}")
    _time_at_main_shape(main_ms, "gram_matvec_rect", None,
                        lambda: _ffma("matvec_rect")(P, X, sq_p, sq, v, **rbf),
                        _rect_bound(2000, 10000, 200, 1, "gram", 4, 1),
                        "2000x10000x200 rbf FFMA tile")
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
        op = gram_matvec.tier_operand(X, tier)
        _time_at_main_shape(
            main_ms, "gram_matvec_sym_tc", "config3" if tier == "f32" else None,
            lambda: gram_matvec.gram_matvec_sym(X, sq, v, precision=tier, operand=op, **poly),
            _sym_bound(49999, 500, 1, "gram", 4, 1, TIER_OF[tier]),
            f"49999x500 poly {tier}")
    _time_at_main_shape(main_ms, "gram_matvec_sym", None,
                        lambda: _ffma("matvec_sym")(X, sq, v, **poly),
                        _sym_bound(49999, 500, 1, "gram", 4, 1), "49999x500 poly FFMA tile")
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
        # "f32" and "highest" run at MNIST width in the mnist-width and
        # highest phases, "bf16" at config 2's shape in the bf16 phase
        records = {"f32": phase, "bf16": "bf16" if phase == "multiclass" else None,
                   "highest": "highest" if phase == "mnist-width" else None}
        for tier in ("f32", "bf16", "highest"):
            key = ("gram_matmat_sym_tc", TIER_OF[tier])
            errs[tier] = _compare(K.RBF, 0.0, X, P, V, tier, rect=False)["gram_matmat_sym_tc"]
            if tier == "f32" or records[tier]:
                main_err[key] = max(main_err.get(key, 0.0), errs[tier][0])
            op = gram_matvec.tier_operand(X, tier)
            _time_at_main_shape(main_ms, "gram_matmat_sym_tc", records[tier],
                                lambda: gram_matmat.gram_matmat_sym(X, sq, V, precision=tier,
                                                                    operand=op, **rbf),
                                _sym_bound(m, d, MC_CLASSES, "gram", 4, 1, TIER_OF[tier],
                                           exp=True),
                                f"{m}x{d} rbf C={MC_CLASSES} {tier}")
        _time_at_main_shape(main_ms, "gram_matmat_sym", None,
                            lambda: _ffma("matmat_sym")(X, sq, V, **rbf),
                            _sym_bound(m, d, MC_CLASSES, "gram", 4, 1),
                            f"{m}x{d} rbf C={MC_CLASSES} FFMA tile")
        rect_errs = {}
        for tier in ("f32", "bf16", "highest"):
            key = ("gram_matmat_rect_tc", TIER_OF[tier])
            rect_errs[tier] = _compare(K.RBF, 0.0, S, P, A, tier)["gram_matmat_rect_tc"]
            if tier == "f32" or records[tier]:
                main_err[key] = max(main_err.get(key, 0.0), rect_errs[tier][0])
            _time_at_main_shape(
                main_ms, "gram_matmat_rect_tc", records[tier],
                lambda: gram_matmat.gram_matmat_rect(P, S, sq_p, sq_s, A, precision=tier, **rbf),
                _rect_bound(n_points, m + 1, d, MC_CLASSES, "gram", 4, 1, TIER_OF[tier],
                            exp=True),
                f"{n_points}x{m + 1}x{d} rbf C={MC_CLASSES} {tier}")
        _time_at_main_shape(main_ms, "gram_matmat_rect", None,
                            lambda: _ffma("matmat_rect")(P, S, sq_p, sq_s, A, **rbf),
                            _rect_bound(n_points, m + 1, d, MC_CLASSES, "gram", 4, 1),
                            f"{n_points}x{m + 1}x{d} rbf C={MC_CLASSES} FFMA tile")
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
    # 10 classes; the tensor-core tiles at "highest" (three TF32 passes),
    # "f32" (TF32) and "bf16", and the FFMA tiles (full float32, on no
    # wrapper's path: what "highest" ran on before the split) beside
    import functools

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
        for tier in ("ffma", "highest", "f32", "bf16"):
            tc = TIER_OF.get(tier)
            sym_entry, rect_entry = _pairs(rhs, "highest" if tc is None else tier,
                                           ffma=tc is None)
            if tc is not None:
                # the sym tile on the operand copy a solve makes once; the
                # rect tile makes its copies per call, as predict does
                sym_entry = (sym_entry[0], functools.partial(
                    sym_entry[1], operand=gram_matvec.tier_operand(X, tier)), sym_entry[2])
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
    for tier in ("tf32x3", "tf32", "bf16"):
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
        if name == "distance_matvec_dual":
            _walk_epilogue_split(args, kw, label)
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


def _compare_times():
    """What ``--compare-build`` times in each checkout, in a process of its
    own, through wrappers and a CSVM that the parent has too: kernels E-H in
    float64 on histogram rows at m = 16384, d = 256 (C = 10 for G and H),
    laplacian and chi-squared; at the ring's block (2500^2 x 200) the
    matvec walk L in float32 and float64, laplacian (Gaussian rows) and
    chi-squared (histogram rows), M in float64 (C = 10) and the rows-only
    walk F (laplacian) in both types; J at "highest" (float32 RBF) at the
    ring's block of config 3's width, 12500^2 x 500; K at "highest" at
    MNIST width's ring block, 15000^2 x 784, C = 10 (beside the split
    bound); G and kernel N's symmetric walk in float32 chi-squared at phase
    10's shape (59999 x 784, C = 10) and N in laplacian at config 2's 9999 x
    200; each in ms beside its bound, the
    ring block's and J back to back (``_back_to_back_ms``: 20 calls, J 5),
    the others the median of 5 calls after 1 warm-up; and
    kernel O's FFMA walk (``_compare_pairs``) at the oao phase's stacks,
    chi-squared and laplacian at (c)'s in float32 and float64 and RBF at
    "highest" at (b)'s and (d)'s; and the float64 chi-squared fit of phase 9's classes (10000 x
    200, 10 classes) and the float64 laplacian fit of phase 8's config 2
    rows (10000 x 200, two classes), epsilon 1e-10, on one device and on
    the four-shard ring, and phase 7's classes at MNIST width on the ring at
    "highest" (float32, the cell's epsilon), s/iteration and iterations.
    Returns {label: [value, bound ms or None]}."""
    import plssvm_tpu_torch as port
    from plssvm_tpu_torch.ops import distance, gram_matmat, gram_matvec, kernel_matrix
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
    # the ring's block: L both types and kinds, M in float64, F beside L
    hist = torch.as_tensor(_draw_histograms(rng, _histogram_classes(rng, 200), 5000)[0],
                           dtype=torch.float64, device="cuda")
    chi2_gamma = _chi2_gamma(rng, hist.cpu().numpy())
    lap = torch.randn(5000, 200, generator=gen, dtype=torch.float64).to("cuda")
    for dtype in (torch.float64, torch.float32):
        tag, itemsize = ("f64", 8) if dtype == torch.float64 else ("f32", 4)
        fp64 = "fp64" if dtype == torch.float64 else None
        for kind, rows, gamma in ((K.CHI_SQUARED, hist, chi2_gamma),
                                  (K.LAPLACIAN, lap, 1.0 / 200)):
            Xr, Xc = rows[:2500].to(dtype).contiguous(), rows[2500:].to(dtype).contiguous()
            kw = dict(kind=kind, gamma=gamma)
            walks = [("distance_matvec_dual", distance.distance_matvec_dual, 1)]
            if kind == K.CHI_SQUARED and dtype == torch.float64:
                walks.append(("distance_matmat_dual", distance.distance_matmat_dual,
                              MC_CLASSES))
            for name, kernel, columns in walks:
                tail = (columns,) if columns > 1 else ()
                v_c, v_r = (torch.randn(2500, *tail, generator=gen,
                                        dtype=torch.float64).to("cuda", dtype)
                            for _ in range(2))
                out[f"{name} {tag} {kind} 2500x2500x200 C={columns}"] = [
                    _back_to_back_ms(lambda: kernel(Xr, Xc, v_c, v_r, **kw)),
                    _dual_bound(2500, 2500, 200, columns, str(kind), itemsize, 0, fp64)[0]]
            if kind == K.LAPLACIAN:
                out[f"distance_matvec_rect {tag} laplacian 2500x2500x200 C=1 (rows only)"] = [
                    _back_to_back_ms(lambda: distance.distance_matvec_rect(Xr, Xc, v_c, **kw)),
                    _rect_bound(2500, 2500, 200, 1, "laplacian", itemsize, 0, fp64)[0]]
    del hist, lap
    # J at "highest" at config 3's ring block (the FFMA walk)
    X = torch.randn(25000, 500, generator=gen, dtype=torch.float64).to("cuda", torch.float32)
    X = X / X.abs().amax(0)
    Xr, Xc = X[:12500].contiguous(), X[12500:].contiguous()
    sq_r, sq_c = (Xr * Xr).sum(-1), (Xc * Xc).sum(-1)
    v_c, v_r = (torch.randn(12500, generator=gen, dtype=torch.float64).to("cuda", torch.float32)
                for _ in range(2))
    out["gram_matvec_dual f32 rbf 12500x12500x500 highest"] = [
        _back_to_back_ms(lambda: gram_matvec.gram_matvec_dual(
            Xr, Xc, sq_r, sq_c, v_c, v_r, kind=K.RBF, gamma=1.0 / 500, coef0=0.0, degree=3,
            precision="highest"), 5, 1),
        _dual_bound(12500, 12500, 500, 1, "gram", 4, 1, exp=True)[0]]
    del X, Xr, Xc
    # K at "highest" at MNIST width's ring block: the split dual tile here,
    # its FFMA tile in a parent before it
    X = torch.randn(30000, 784, generator=gen, dtype=torch.float64).to("cuda", torch.float32)
    Xr, Xc = X[:15000].contiguous(), X[15000:].contiguous()
    V_c, V_r = (torch.randn(15000, MC_CLASSES, generator=gen, dtype=torch.float64).to(
        "cuda", torch.float32) for _ in range(2))
    out[f"gram_matmat_dual f32 rbf 15000x15000x784 C={MC_CLASSES} highest, copies per call "
        "(split bound)"] = [
        _median_ms(lambda: gram_matmat.gram_matmat_dual(
            Xr, Xc, (Xr * Xr).sum(-1), (Xc * Xc).sum(-1), V_c, V_r, kind=K.RBF,
            gamma=1.0 / 784, coef0=0.0, degree=3, precision="highest"), 5, 1),
        _dual_bound(15000, 15000, 784, MC_CLASSES, "gram", 4, 1, "tf32x3", exp=True)[0]]
    del X, Xr, Xc, V_c, V_r
    X = torch.as_tensor(_draw_histograms(rng, _histogram_classes(rng, 784), 59999)[0],
                        dtype=torch.float32, device="cuda")
    V = torch.randn(59999, MC_CLASSES, generator=gen, dtype=torch.float64).to("cuda",
                                                                              torch.float32)
    out[f"distance_matmat_sym f32 chi_squared 59999x784 C={MC_CLASSES}"] = [
        _median_ms(lambda: distance.distance_matmat_sym(X, V, kind=K.CHI_SQUARED,
                                                        gamma=1.0 / 784), 5, 1),
        _sym_bound(59999, 784, MC_CLASSES, "chi_squared", 4)[0]]
    del V
    # kernel N's symmetric walk: chi-squared at chi2-width (14.4 GB) and
    # laplacian at config 2's 9999 x 200 (phase 8's explicit build)
    out["kernel_matrix_sym f32 chi_squared 59999x784"] = [
        _median_ms(lambda: kernel_matrix.kernel_matrix_sym(X, kind=K.CHI_SQUARED,
                                                           gamma=1.0 / 784), 5, 1),
        _n_bound(59999, 59999, 784, "chi_squared", 4, 4, True)[0]]
    del X
    lap = torch.randn(9999, 200, generator=gen, dtype=torch.float64).to("cuda", torch.float32)
    out["kernel_matrix_sym f32 laplacian 9999x200"] = [
        _median_ms(lambda: kernel_matrix.kernel_matrix_sym(lap, kind=K.LAPLACIAN,
                                                           gamma=1.0 / 200), 20, 2),
        _n_bound(9999, 9999, 200, "laplacian", 4, 4, True)[0]]
    del lap
    # the MNIST-width ring at "highest" (phase 7's classes): K on the split
    # dual tile here, on its FFMA tile in a parent before it
    g_rng = np.random.default_rng(SEED + 4)
    means = _class_means(g_rng, 784)
    X, y = _draw(g_rng, means, 60000)
    X_test, y_test = _draw(g_rng, means, 10000)
    cell = dict(labels=y_test, params=dict(kernel_type="rbf"))
    run = _ring_run(cell, port.DataSet(X, y, dtype=np.float32),
                    port.DataSet(X_test, y_test, dtype=np.float32), np.float32, EPSILON,
                    ["cuda:0"] * RING_SHARDS, precision="highest")
    out["MNIST-width ring highest, 60000x784: s/iteration"] = [run["s_per_it"], None]
    out["MNIST-width ring highest, 60000x784: iterations"] = [run["iterations"], None]
    del X, X_test, run
    # phase 9's classes and phase 8's config 2 rows, in memory
    rng = np.random.default_rng(SEED + 12)
    probs = _histogram_classes(rng, 200)
    X, y, _ = _draw_histograms(rng, probs, 10000)
    X_test, y_test, _ = _draw_histograms(rng, probs, 2000)
    chi2_cell = dict(labels=y_test, params=dict(kernel_type="chi_squared",
                                                gamma=_chi2_gamma(rng, X)))
    chi2_data = (X, y, X_test, y_test)
    # kernel O's FFMA walk at the oao phase's stacks: (c), these classes'
    # 45 machines, chi-squared and laplacian in both types; (b) and (d),
    # the 10 Gaussian classes of phases 5 and 7 (their first draws), RBF
    # at "highest"
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        Xb, _, lens = _pairs_stack(X, y, dtype)
        for kind, g in ((K.CHI_SQUARED, chi2_cell["params"]["gamma"]), (K.LAPLACIAN, 1.0 / 200)):
            out[f"pairs_matvec (ffma) {tag} {kind} at (c)'s stack {tuple(Xb.shape)}"] = \
                _compare_pairs(Xb, None, lens, kind, g, gen)
        del Xb
    for cell, seed, n, d in (("b", SEED + 3, 10000, 200), ("d", SEED + 4, 60000, 784)):
        g_rng = np.random.default_rng(seed)
        Xm, ym = _draw(g_rng, _class_means(g_rng, d), n)
        Xb, sq, lens = _pairs_stack(Xm, ym, torch.float32)
        out[f"pairs_matvec (ffma) f32 rbf highest at ({cell})'s stack {tuple(Xb.shape)}"] = \
            _compare_pairs(Xb, sq, lens, K.RBF, 1.0 / d, gen, "highest")
        del Xm, Xb, sq
    rng = np.random.default_rng(SEED)  # _write_config2's draws
    config2 = []
    for n in (10000, 2000):
        labels = np.where(rng.random(n) < 0.5, -1, 1)
        config2 += [rng.normal(size=(n, 200)) + 0.1 * labels[:, None], labels]
    lap_cell = dict(labels=config2[3], params=dict(kernel_type="laplacian"))
    for fit, cell, (X, y, X_test, y_test) in (
        (f"chi-squared f64 fit, 10000x200, {MC_CLASSES} classes", chi2_cell, chi2_data),
        ("laplacian f64 fit, config 2's 10000x200", lap_cell, config2),
    ):
        data = (port.DataSet(X, y, dtype=np.float64),
                port.DataSet(X_test, y_test, dtype=np.float64))
        for label, devices in (("one device", None), ("ring", ["cuda:0"] * RING_SHARDS)):
            run = _ring_run(cell, *data, np.float64, RING_F64_EPSILON, devices)
            out[f"{fit}, {label}: s/iteration"] = [run["s_per_it"], None]
            out[f"{fit}, {label}: iterations"] = [run["iterations"], None]
    return out


def _compare_pairs(Xb, sq, lens, kind, gamma, gen, precision="f32"):
    """[ms, bound ms] of kernel O at one stack: the median of 5 calls
    after 1 warm-up on a seeded right-hand side, beside ``_pairs_bound``."""
    from plssvm_tpu_torch.ops import pairs

    V = _pairs_rhs(Xb, lens, gen)
    kw = dict(kind=kind, gamma=gamma, coef0=0.0, degree=3, precision=precision)
    ms = _median_ms(lambda: pairs.pairs_matvec(Xb, sq, V, lens, **kw), 5, 1)
    return [ms, _pairs_bound(lens.cpu().numpy(), Xb.shape[2], str(kind), Xb.element_size())[0]]


def _oao_f64_times():
    """What ``--oao-f64-compare`` times in each checkout, in a process of
    its own: oao (b)'s float64 batched fit (phase 5's 10 classes, 10000 x
    200, RBF, C = 1, epsilon OAO_F64_EPSILON, drawn in memory) on one device
    and, as in (e), with its machines split over 4 x cuda:0; per placement 1
    warm-up and 5 timed fits, the median of the fit's seconds (the
    tracker's ``cg.total_runtime``) per block iteration, and the block
    iterations.  Returns {label: [value, None]}."""
    import plssvm_tpu_torch as port
    from plssvm_tpu_torch.csvm import CSVM

    port.set_verbosity("quiet")
    rng = np.random.default_rng(SEED + 3)
    X, y = _draw(rng, _class_means(rng, 200), 10000)
    train = port.DataSet(X, y, dtype=np.float64)
    out = {}
    for label, where in (("(b) one device", dict(device="cuda")),
                         ("(e) 4 x cuda:0", dict(devices=["cuda:0"] * 4))):
        svm = CSVM(backend="cuda", dtype=np.float64, kernel_type="rbf", cost=1.0,
                   oao_batch="batched", **where)
        per_iteration = []
        for rep in range(6):
            port.global_tracker.clear()
            svm.fit(train, classification="oao", epsilon=OAO_F64_EPSILON)
            torch.cuda.synchronize()
            block = _tracked("cg", "block_iterations")
            if rep:
                per_iteration.append(_tracked("cg", "total_runtime") / 1000 / block)
        out[f"oao {label} float64 fit s/iteration"] = [statistics.median(per_iteration), None]
        out[f"oao {label} float64 block iterations"] = [block, None]
    return out


#: run in a checkout: import the package there and print the timings of
#: the chip_smoke.py named by the first argument (its function named by the
#: second: _compare_times or _oao_f64_times)
_TIMES = (
    "import importlib.util, json, sys; "
    "spec = importlib.util.spec_from_file_location('chip_smoke', sys.argv[1]); "
    "smoke = importlib.util.module_from_spec(spec); spec.loader.exec_module(smoke); "
    "print(json.dumps(getattr(smoke, sys.argv[2])()))"
)


def phase_compare(other, times="_compare_times"):
    """``--compare-build``: ``_compare_times`` (``--oao-f64-compare``:
    ``_oao_f64_times``) in the other checkout (its kernels, built in the
    build phase) and in this one, each in a process of its own, in the
    order other, here, here, other; per label both checkouts' values (ms,
    s/iteration or iterations), the faster of each pair, their ratio and
    the shares of the bound, logged."""
    here = os.path.dirname(os.path.abspath(__file__))
    runs = []
    for root in (other, here, here, other):
        proc = subprocess.run([sys.executable, "-c", _TIMES, os.path.abspath(__file__), times],
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


@contextlib.contextmanager
def _model_io_seconds():
    """Seconds spent in ``Model.load`` and ``Model.save`` (the model file's
    parse and write) while the block runs, by wrapping both."""
    from plssvm_tpu_torch.model import Model

    spent = {"load": 0.0, "save": 0.0}
    load, save = Model.__dict__["load"], Model.save

    def timed_load(cls, *args, **kwargs):
        start = time.perf_counter()
        try:
            return load.__func__(cls, *args, **kwargs)
        finally:
            spent["load"] += time.perf_counter() - start

    def timed_save(self, *args, **kwargs):
        start = time.perf_counter()
        try:
            return save(self, *args, **kwargs)
        finally:
            spent["save"] += time.perf_counter() - start

    Model.load, Model.save = classmethod(timed_load), timed_save
    try:
        yield spent
    finally:
        Model.load, Model.save = load, save


def _cli_fit_predict(phase, train_file, test_file, tmp, flags, solver="cg_implicit",
                     parse=int, predict_flags=()):
    """Train (``--solver solver``: the implicit solver unless asked, so
    that the phases built to launch a kernel launch it) and predict through
    the port's CLIs on the card; returns (fit seconds, predict seconds,
    predicted labels, file I/O): the I/O holds
    the seconds of the fit's data parse and model write and of the
    predict's model and data parse, and the native library's parses and
    writes over both runs (``native/loader.py``'s counters).  ``parse``
    reads a line of the predict file (float for a regression model's
    values); ``predict_flags`` go to the predict CLI."""
    import plssvm_tpu_torch as port
    from plssvm_tpu_torch.cli import predict as predict_cli
    from plssvm_tpu_torch.cli import train as train_cli
    from plssvm_tpu_torch.native import loader

    model_file = os.path.join(tmp, f"{phase}.model")
    out_file = os.path.join(tmp, f"{phase}.predict")
    common = ["-b", "cuda", "-p", "gpu", "-q"]
    port.global_tracker.clear()
    loader.reset_counts()
    with _model_io_seconds() as model_io:
        t0 = time.perf_counter()
        rc = train_cli.main(common + ["--solver", solver] + flags + [train_file, model_file])
        t1 = time.perf_counter()
        fit_read = _tracked("data_set_read", "time") / 1000 if rc == 0 else 0.0
        rc_predict = predict_cli.main(common + list(predict_flags)
                                      + [test_file, model_file, out_file])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    if rc != 0 or rc_predict != 0:
        raise AssertionError(f"{phase}: train rc {rc}, predict rc {rc_predict}")
    io = {"fit_parse": fit_read + model_io["save"],
          "predict_parse": _tracked("data_set_read", "time") / 1000 + model_io["load"],
          "native": (loader.native_parses, loader.native_writes)}
    with open(out_file, encoding="utf-8") as fh:
        predicted = np.asarray([parse(line) for line in fh])
    return t1 - t0, t2 - t1, predicted, io


def _automatic(phase, label, n, d, kind, classes=2, dtype=np.float32, precision="f32",
               devices=None):
    """Log what ``solver="automatic"`` would resolve to for a fit of ``n``
    points of ``d`` features and ``classes`` labels at the phase's shape:
    the phases built to launch a kernel pin ``cg_implicit``."""
    import plssvm_tpu_torch as port
    from plssvm_tpu_torch.parameter import KernelFunctionType as K

    where = dict(device="cuda") if devices is None else dict(devices=devices)
    svm = port.CSVM(backend="cuda", dtype=dtype, gram_precision=precision,
                    kernel_type=kind, **where)
    n_dev = len(svm.devices[:n - 1]) if svm.devices else 1
    columns = classes if classes > 2 else 1
    explicit = svm._use_explicit_solver(n - 1, d, K.from_string(kind), n_dev, columns)
    needs = max(svm._explicit_bytes_per_device(n - 1, n_dev).values())
    budget = svm._explicit_budget(svm.device, n - 1, d, columns)
    log(phase, f"{label}: solver='automatic' would take "
        f"{'cg_explicit' if explicit else 'cg_implicit'} at this shape (K {needs} bytes on "
        f"{svm.device}, budget {budget} bytes); the phase pins cg_implicit")


def _check_cli_run(phase, label, fit_s, predict_s, io, accuracy, floor, launches,
                   plain_calls, sym_name, rect_name):
    """Log a CLI run and check it: the symmetric kernel launched once for
    the initial residual, once per iteration and once more every 50th; the
    rectangular one at least once; no plain version called; the accuracy
    floor met; the three files parsed (training data, model, test data)
    and the model written by the native library, none through the NumPy
    path.  The log splits each CLI's seconds into its file I/O and the
    rest."""
    iterations = _tracked("cg", "iterations")
    cg_ms = _tracked("cg", "total_runtime")
    per_class = _tracked("cg", "iterations_per_class") if "matmat" in sym_name else None
    log(phase, f"{label} f32 (cuda): {iterations} CG iterations"
        + (f" (per class {per_class})" if per_class else "")
        + f", {cg_ms / 1000 / iterations:.6f} s/iteration, CG {cg_ms / 1000:.3f} s, "
        f"fit (CLI, parse included) {fit_s:.3f} s, predict (CLI) {predict_s:.3f} s, "
        f"accuracy {accuracy:.4f}, launches {launches}, plain calls {plain_calls}")
    log(phase, f"{label} file I/O (native parser): fit {io['fit_parse']:.3f} s of "
        f"{fit_s:.3f} (the rest {fit_s - io['fit_parse']:.3f} s), predict "
        f"{io['predict_parse']:.3f} s of {predict_s:.3f} (the rest "
        f"{predict_s - io['predict_parse']:.3f} s); native parses, writes {io['native']}")
    if io["native"] != (3, 1):
        raise AssertionError(f"{phase}: the native library carried {io['native']} of the "
                             "3 parses and 1 write: a file went through the NumPy path")
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
                      cost=1.0, solver="cg_implicit", **params)
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
                        kernel_type=kernel_type, cost=1.0, solver="cg_implicit")
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
    for dtype in (np.float32, np.float64):
        _automatic("e2e", f"config 2 rbf {np.dtype(dtype).name}", 10000, 200, "rbf",
                   dtype=dtype)
    gram_matvec.reset_counts()
    fit_s, predict_s, predicted, io = _cli_fit_predict(
        "e2e", train_file, test_file, tmp,
        ["-t", "2", "-c", "1", "-e", str(EPSILON)])
    launches = {
        "gram_matvec_sym_tc": gram_matvec.sym_tc_launches,
        "gram_matvec_rect_tc": gram_matvec.rect_tc_launches,
        # the fixed-order sums of A's and B's walks (csrc/fixed_sum.cuh)
        "fixed_sum": gram_matvec.fixed_sum_launches(),
    }
    if gram_matvec.sym_launches + gram_matvec.rect_launches != 0:
        raise AssertionError("e2e: the f32 fit or predict took the FFMA tile")
    if launches["fixed_sum"] < launches["gram_matvec_sym_tc"]:
        raise AssertionError(f"e2e: {launches['fixed_sum']} fixed-order sums for "
                             f"{launches['gram_matvec_sym_tc']} products of kernel A")
    _check_cli_run("e2e", "config 2", fit_s, predict_s, io,
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


def _write_multiclass(tmp):
    """Seeded 10-class 10000 x 200 train and 2000 x 200 test files (phase
    5's), written with the port's LIBSVM writer: {name: (path, labels)}."""
    from plssvm_tpu_torch import DataSet

    start = time.perf_counter()
    rng = np.random.default_rng(SEED + 3)
    means = _class_means(rng, 200)
    files = {}
    for name, n in (("mc_train", 10000), ("mc_test", 2000)):
        X, y = _draw(rng, means, n)
        files[name] = (os.path.join(tmp, f"{name}.libsvm"), y)
        DataSet(X, y).save(files[name][0])
    log("multiclass", f"wrote {MC_CLASSES}-class 10000x200 + 2000x200 LIBSVM "
        f"files in {time.perf_counter() - start:.2f} s")
    return files


def phase_multiclass_cli(tmp, files):
    from plssvm_tpu_torch.ops import gram_matmat, gram_matvec, matvec

    train_file, test_file = files["mc_train"][0], files["mc_test"][0]
    for dtype in (np.float32, np.float64):
        _automatic("multiclass", f"{MC_CLASSES} classes rbf {np.dtype(dtype).name}", 10000,
                   200, "rbf", MC_CLASSES, dtype)
    gram_matvec.reset_counts()
    gram_matmat.reset_counts()
    fit_s, predict_s, predicted, io = _cli_fit_predict(
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
    _check_cli_run("multiclass", f"{MC_CLASSES} classes", fit_s, predict_s, io,
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
                    kernel_type="rbf", cost=1.0, solver="cg_implicit")
    _automatic("mnist-width", f"rbf 60000x784 {MC_CLASSES} classes f32", 60000, 784, "rbf",
               MC_CLASSES)
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
                params=dict(kernel_type="rbf"),
                implicit=dict(predicted=predicted, fit_s=t1 - t0, iterations=iterations,
                              s_per_it=cg_ms / 1000 / iterations, accuracy=accuracy))
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
                    kernel_type="polynomial", solver="cg_implicit")
    _automatic("config3", "poly 50000x500 f32", n, d, "polynomial")
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
    from plssvm_tpu_torch.native import loader
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
        loader.reset_counts()
        t0 = time.perf_counter()
        rc = train_cli.main(["-b", "cuda", "-p", "gpu", "-q", "--gram_precision", "bf16",
                             "--solver", "cg_implicit", "-t", "2", "-c", "1", "-e",
                             str(EPSILON), train, model_file])
        _automatic("bf16", f"{label} bf16", 10000, 200, "rbf",
                   MC_CLASSES if sym.startswith("gram_matmat") else 2, precision="bf16")
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
        if (loader.native_parses, loader.native_writes) != (3, 1):
            raise AssertionError(f"bf16 {label}: a file went through the NumPy path")
        if accuracy < floor:
            raise AssertionError(f"bf16 {label}: accuracy {accuracy} below {floor}")
    return launches


def phase_highest(tmp, config2_files, mnist_cell):
    """The "highest" tier end to end on the implicit path, kernels A-D on
    the tensor-core tiles in three TF32 passes over the split operands:
    phase 4's config 2 files through ``plssvm-torch-train --gram_precision
    highest --solver cg_implicit``, predicted through
    ``CSVM(gram_precision="highest")`` (A, B); phase 7's 10 classes at
    MNIST width through ``CSVM(gram_precision="highest",
    solver="cg_implicit")``, predicted at "highest" (C, D).  Each: A or C
    launched once for the initial residual, once per iteration and every
    50th, B or D at least once, no FFMA-tile launch and no plain call; the
    accuracy floor of its cell; labels against a float64 fit of the same
    data on >= 0.995 (the f32/f64 gate); s/iteration logged beside the
    cell's TF32 fit."""
    import plssvm_tpu_torch as port
    from plssvm_tpu_torch.cli import train as train_cli
    from plssvm_tpu_torch.ops import gram_matmat, gram_matvec, matvec

    def reset():
        gram_matvec.reset_counts()
        gram_matmat.reset_counts()
        port.global_tracker.clear()

    def check(label, module, sym, rect, iterations, accuracy, floor):
        counts = {sym: module.sym_tc_launches, rect: module.rect_tc_launches}
        ffma = (gram_matvec.sym_launches + gram_matmat.sym_launches
                + gram_matvec.rect_launches + gram_matmat.rect_launches)
        plain = (matvec.sym_plain_calls + matvec.rect_plain_calls
                 + matvec.sym_matmat_plain_calls + matvec.rect_matmat_plain_calls)
        log("highest", f"{label}: launches {counts} (tensor cores, three TF32 passes), "
            f"FFMA-tile launches {ffma}, plain calls {plain}")
        if counts[sym] != 1 + iterations + iterations // 50 or counts[rect] <= 0 \
                or ffma != 0 or plain != 0:
            raise AssertionError(f"highest {label} did not go through the split tiles only")
        if accuracy < floor:
            raise AssertionError(f"highest {label}: accuracy {accuracy} below {floor}")
        return counts

    launches = {}
    (train_file, _), (test_file, test_labels) = config2_files
    _automatic("highest", "config 2 highest", 10000, 200, "rbf", precision="highest")
    reset()
    model_file = os.path.join(tmp, "highest.model")
    t0 = time.perf_counter()
    rc = train_cli.main(["-b", "cuda", "-p", "gpu", "-q", "--gram_precision", "highest",
                         "--solver", "cg_implicit", "-t", "2", "-c", "1", "-e",
                         str(EPSILON), train_file, model_file])
    t1 = time.perf_counter()
    if rc != 0:
        raise AssertionError(f"highest config 2: train rc {rc}")
    iterations = _tracked("cg", "iterations")
    s_per_it = _tracked("cg", "total_runtime") / 1000 / iterations
    svm = port.CSVM(backend="cuda", device="cuda", gram_precision="highest")
    predicted = svm.predict(port.Model.load(model_file), port.DataSet(test_file))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    accuracy = float(np.mean(predicted == test_labels))
    launches.update(check("config 2", gram_matvec, "gram_matvec_sym_tc",
                          "gram_matvec_rect_tc", iterations, accuracy, ACCURACY_FLOOR))
    # the TF32 fit of the same file beside, in memory
    port.global_tracker.clear()
    port.CSVM(backend="cuda", device="cuda", kernel_type="rbf", cost=1.0,
              solver="cg_implicit").fit(port.DataSet(train_file), epsilon=EPSILON)
    tf32_it = _tracked("cg", "iterations")
    tf32_s = _tracked("cg", "total_runtime") / 1000 / tf32_it
    log("highest", f"config 2 highest (cuda): {iterations} CG iterations, {s_per_it:.6f} "
        f"s/iteration (TF32 beside: {tf32_it} at {tf32_s:.6f}), fit (CLI) {t1 - t0:.3f} s, "
        f"predict (CSVM, file parse included) {t2 - t1:.3f} s, accuracy {accuracy:.4f}")
    _f64_agreement("highest", "config 2 highest", train_file, test_file, predicted, EPSILON,
                   kernel_type="rbf")

    train, test = mnist_cell["make"](np.float32)
    _automatic("highest", f"rbf 60000x784 {MC_CLASSES} classes highest", 60000, 784, "rbf",
               MC_CLASSES, precision="highest")
    svm = port.CSVM(backend="cuda", device="cuda", dtype=np.float32, kernel_type="rbf",
                    cost=1.0, solver="cg_implicit", gram_precision="highest")
    reset()
    t0 = time.perf_counter()
    model = svm.fit(train, epsilon=mnist_cell["epsilon"])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    predicted = svm.predict(model, test)
    t2 = time.perf_counter()
    iterations = _tracked("cg", "iterations")
    s_per_it = _tracked("cg", "total_runtime") / 1000 / iterations
    accuracy = float(np.mean(predicted == mnist_cell["labels"]))
    if not (np.all(np.isfinite(model.alpha)) and np.all(np.isfinite(model.rho))):
        raise AssertionError("highest MNIST width: non-finite model")
    launches.update(check(f"rbf 60000x784 {MC_CLASSES} classes", gram_matmat,
                          "gram_matmat_sym_tc", "gram_matmat_rect_tc", iterations, accuracy,
                          mnist_cell["floor"]))
    tf32 = mnist_cell["implicit"]
    log("highest", f"rbf 60000x784 {MC_CLASSES} classes highest (cuda): {iterations} "
        f"block-CG iterations, {s_per_it:.6f} s/iteration (TF32 beside: "
        f"{tf32['iterations']} at {tf32['s_per_it']:.6f}), fit {t1 - t0:.3f} s, predict "
        f"10000 points {t2 - t1:.3f} s, accuracy {accuracy:.4f} (TF32 "
        f"{tf32['accuracy']:.4f}), label agreement with the TF32 fit "
        f"{float(np.mean(predicted == tf32['predicted'])):.4f}")
    del train, test
    train64, test64 = mnist_cell["make"](np.float64)
    svm64 = port.CSVM(backend="cuda", device="cuda", dtype=np.float64, kernel_type="rbf",
                      cost=1.0, solver="cg_implicit")
    port.global_tracker.clear()
    t0 = time.perf_counter()
    model64 = svm64.fit(train64, epsilon=mnist_cell["epsilon"])
    t1 = time.perf_counter()
    agree = float(np.mean(svm64.predict(model64, test64) == predicted))
    log("highest", f"rbf 60000x784 {MC_CLASSES} classes f64 (cuda): {model64.n_iter} "
        f"block-CG iterations, fit {t1 - t0:.3f} s, highest/f64 label agreement {agree:.4f}")
    if agree < 0.995:
        raise AssertionError(f"highest and f64 agree on {agree} of the labels")
    return launches


def phase_laplacian_cli(tmp, config2_files):
    """Phase 8: phase 4's config 2 files with -t 4: only the kernel
    differs from phase 4."""
    from plssvm_tpu_torch.ops import distance

    (train_file, _), (test_file, test_labels) = config2_files
    _automatic("laplacian", "config 2 -t 4", 10000, 200, "laplacian")
    distance.reset_counts()
    fit_s, predict_s, predicted, io = _cli_fit_predict(
        "laplacian", train_file, test_file, tmp,
        ["-t", "4", "-c", "1", "-e", str(EPSILON)])
    launches, plain_calls = _distance_counts()
    _check_cli_run("laplacian", "config 2 -t 4", fit_s, predict_s, io,
                   float(np.mean(predicted == test_labels)),
                   LAPLACIAN_ACCURACY_FLOOR, launches, plain_calls,
                   "distance_matvec_sym", "distance_matvec_rect")
    cell = _cli_cell(train_file, test_file, test_labels, EPSILON,
                     LAPLACIAN_ACCURACY_FLOOR, kernel_type="laplacian")
    cell["predicted"] = predicted
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
    _automatic("chi2-cli", f"{MC_CLASSES} classes -t 5", 10000, 200, "chi_squared",
               MC_CLASSES)
    distance.reset_counts()
    fit_s, predict_s, predicted, io = _cli_fit_predict(
        "chi2-cli", train_file, test_file, tmp,
        ["-t", "5", "-g", repr(gamma), "-c", "1", "-e", str(CHI2_EPSILON)])
    launches, plain_calls = _distance_counts()
    _check_cli_run("chi2-cli", f"{MC_CLASSES} classes -t 5", fit_s, predict_s, io,
                   float(np.mean(predicted == y_test)), CHI2_ACCURACY_FLOOR,
                   launches, plain_calls, "distance_matmat_sym",
                   "distance_matmat_rect")
    cell = _cli_cell(train_file, test_file, y_test, CHI2_EPSILON,
                     CHI2_ACCURACY_FLOOR, kernel_type="chi_squared", gamma=gamma)
    _f64_agreement("chi2-cli", f"{MC_CLASSES} classes -t 5", train_file,
                   test_file, predicted, CHI2_EPSILON,
                   kernel_type="chi_squared", gamma=gamma)
    return {k: launches[k] for k in ("distance_matmat_sym", "distance_matmat_rect")}, cell


def _chi2_width_data():
    """Phase 10's data: the 10 histogram classes at MNIST's width, count
    and split (60000 + 10000 x 784), their gamma and Bayes-optimal
    accuracy, and the seconds it took to make them."""
    rng = np.random.default_rng(SEED + 13)
    probs = _histogram_classes(rng, 784)
    start = time.perf_counter()
    X, y, _ = _draw_histograms(rng, probs, 60000)
    X_test, y_test, _ = _draw_histograms(rng, probs, 10000)
    gamma = _chi2_gamma(rng, X)
    bayes = _bayes_accuracy(rng, probs)
    return X, y, X_test, y_test, gamma, bayes, time.perf_counter() - start


def phase_chi2_width(g_chi_ms):
    """Phase 10: the histogram classes at MNIST's width, count and split,
    through CSVM in memory; max_iter capped from kernel G's time."""
    import plssvm_tpu_torch as port
    from plssvm_tpu_torch.ops import distance

    X, y, X_test, y_test, gamma, bayes, made_s = _chi2_width_data()
    train = port.DataSet(X, y, dtype=np.float32)
    test = port.DataSet(X_test, y_test, dtype=np.float32)
    # kernel G at this shape, from the kernels phase; the iteration costs
    # one launch and the loop around it
    per_launch = g_chi_ms / 1000
    max_iter = max(5, int(CHI_WIDTH_CG_SECONDS / per_launch) - 2)
    log("chi2-width", f"made {MC_CLASSES}-class 60000x784 + 10000x784 histograms "
        f"({np.mean(X == 0):.3f} of the entries 0) in {made_s:.2f} s; "
        f"gamma {gamma:.6f}; Bayes-optimal accuracy {bayes:.4f}; kernel G "
        f"{per_launch:.3f} s per launch (kernels phase), max_iter {max_iter}")
    svm = port.CSVM(backend="cuda", device="cuda", dtype=np.float32,
                    kernel_type="chi_squared", gamma=gamma, cost=1.0, solver="cg_implicit")
    _automatic("chi2-width", f"chi-squared 60000x784 {MC_CLASSES} classes f32", 60000, 784,
               "chi_squared", MC_CLASSES)
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
    implicit = dict(predicted=predicted, fit_s=t1 - t0, iterations=iterations,
                    s_per_it=cg_ms / 1000 / iterations, accuracy=accuracy)
    cell = dict(train=train, test=test, labels=y_test, gamma=gamma, max_iter=max_iter,
                implicit=implicit)
    return {k: launches[k] for k in ("distance_matmat_sym", "distance_matmat_rect")}, cell


#: shapes of kernel N's checks against its plain version: one entry,
#: ragged edges of one and several tiles, d past one chunk, many tiles
N_SHAPES = ((1, 1, 3), (70, 70, 5), (130, 131, 17), (257, 300, 33), (1000, 999, 784))
#: rows of the chi2-width build held against the plain version: the first
#: and the last, and rows from 35792 on, whose entries lie past INT32_MAX
#: (35792 x 59999 > 2^31)
N_SAMPLE_ROWS = (0, 1, 17, 29999, 35791, 35792, 47000, 59997, 59998)
#: the kernels phase's shape, where kernel N is timed beside its plain
#: version; in float64 at N_TIMING_M_F64 rows, as kernels E-H in float64
N_TIMING_M, N_TIMING_D, N_TIMING_M_F64 = 16384, 256, 8192
#: the explicit budget's edge: the feature count of the fits whose K just
#: fits the budget, their cap on CG iterations (a read of K ~25 ms), and
#: the room under the budget their K leaves for what the fit itself puts
#: on the card before it resolves the solver (X, the labels)
EDGE_D, EDGE_MAX_ITER, EDGE_SLACK = 16, 10, 256 << 20
#: ROADMAP Queue 3 item 2's case: runs per solver and their cap
STALL_RUNS, STALL_MAX_ITER = 12, 500


def _n_bound(mr, mc, d, kind, itemsize, out_itemsize, symmetric):
    """The bound of kernel N: the pair work of mr mc pairs (half of them,
    m (m + 1) / 2, for the symmetric walk) over d features and the bytes of
    X (or Xr and Xc) read once and K written once."""
    pairs = mr * (mr + 1) / 2 if symmetric else float(mr) * mc
    n_bytes = itemsize * (mr if symmetric else mr + mc) * d + out_itemsize * float(mr) * mc
    return _bound(pairs, d, 0.0, kind, n_bytes, None if itemsize == 4 else "fp64")


def _kernel_n_checks(gen):
    """Kernel N's two walks against their plain version on the card:
    laplacian and chi-squared, float32 and float64, stored in the type and
    in bfloat16, on zero-rich rows at N_SHAPES.  K in its type within the
    type's tolerance (``_check_close``); bfloat16 within one bf16 rounding
    (2^-8, K <= 1) of the plain version's bfloat16; the symmetric walk
    exactly symmetric with a unit diagonal.  Returns the largest max|err|
    per walk and type, {(walk, "f32" or "f64"): err}."""
    from plssvm_tpu_torch.ops import kernel_matrix as km
    from plssvm_tpu_torch.parameter import KernelFunctionType as K

    worst = {(walk, t): 0.0 for walk in ("kernel_matrix_sym", "kernel_matrix_rect")
             for t in ("f32", "f64")}
    for dtype in (torch.float32, torch.float64):
        t = "f32" if dtype == torch.float32 else "f64"
        for kind in (K.LAPLACIAN, K.CHI_SQUARED):
            for out in (None, torch.bfloat16):
                for mr, mc, d in N_SHAPES:
                    X, Y = _zero_rich(mr, d, dtype, gen), _zero_rich(mc, d, dtype, gen)
                    kw = dict(kind=kind, gamma=1.0 / d, out_dtype=out)
                    label = f"{kind} {dtype} {out or 'stored in its type'} {mr}x{mc}x{d}"
                    sym = km.kernel_matrix_sym(X, **kw)
                    for name, got, want in (
                            ("kernel_matrix_sym", sym, km.kernel_matrix_sym_plain(X, **kw)),
                            ("kernel_matrix_rect", km.kernel_matrix_rect(X, Y, **kw),
                             km.kernel_matrix_rect_plain(X, Y, **kw))):
                        if out is None:
                            err = _check_close(f"{name} {label}", got, want)[0]
                            worst[(name, t)] = max(worst[(name, t)], err)
                        else:
                            torch.cuda.synchronize()
                            err = float((got.float() - want.float()).abs().max())
                            if got.dtype != torch.bfloat16 or not err <= 2.0 ** -8:
                                raise AssertionError(f"{name} {label}: max|err| {err}")
                    if not (torch.equal(sym, sym.T)
                            and bool((sym.diagonal() == 1).all())):
                        raise AssertionError(f"kernel_matrix_sym {label}: not symmetric "
                                             "with a unit diagonal")
                    # the symmetric walk stores what the rect walk of X against
                    # itself computes, bit for bit: only its store differs
                    if not torch.equal(sym, km.kernel_matrix_rect(X, X, **kw)):
                        raise AssertionError(f"kernel_matrix_sym {label}: differs from the "
                                             "rect walk of X against itself")
    log("explicit", f"kernel N against its plain version: {len(N_SHAPES)} shapes x "
        f"laplacian, chi-squared x float32, float64 x stored in the type, bf16: max|err| "
        + ", ".join(f"{walk[len('kernel_matrix_'):]} {t} {err:.3e}"
                    for (walk, t), err in worst.items())
        + "; the symmetric walk exactly symmetric with a unit diagonal, bit for bit the "
        "rect walk of X against itself")
    return worst


def _kernel_n_main_shapes(gen, chi2_width, chi2_cell, config2_files):
    """Kernel N at the main paths' shapes: the chi2-width build (59999 x
    784, float32 chi-squared, 14.4 GB), timed beside its bound, N_SAMPLE_ROWS
    held against the plain version and the per-entry check of
    ``ops/entry_check.py`` on ten columns; the same build in float64 (28.8
    GB) timed beside its bound (the explicit phase checks the one its fit
    builds); config 2's laplacian K (9999 x 200, the ``-t 4`` CLI fit's)
    whole against the plain version and timed beside it; the ring's row
    block of the chi2-cli cell (2500 x 9999 x 200) against the plain
    version, timed beside it and per entry.  Then both walks and their
    plain versions at 16384 x 256 (chi-squared, zero-rich rows), the
    symmetric one in float64 at 8192 x 256.  Returns (main_err, timing,
    bounds, main_ms) entries."""
    import plssvm_tpu_torch as port
    from plssvm_tpu_torch.ops import kernel_matrix as km
    from plssvm_tpu_torch.ops.entry_check import entry_errors
    from plssvm_tpu_torch.parallel import sharded
    from plssvm_tpu_torch.parameter import KernelFunctionType as K

    main_err, timing, bounds, main_ms = {}, {}, {}, {}
    sym_key, rect_key = ("kernel_matrix_sym", "chi_squared"), ("kernel_matrix_rect", "chi_squared")
    f64_key, lap_key = ("kernel_matrix_sym", "f64"), ("kernel_matrix_sym", "laplacian")
    X = torch.as_tensor(np.asarray(chi2_width["train"].data)[:-1], device="cuda")
    m, d = X.shape
    kw = dict(kind=K.CHI_SQUARED, gamma=chi2_width["gamma"])
    bound = _n_bound(m, m, d, "chi_squared", 4, 4, True)
    ms = _median_ms(lambda: km.kernel_matrix_sym(X, **kw), 3, 1)
    _check_share("kernel_matrix_sym", f"{m}x{d}", ms, bound[0])
    main_ms[("kernel_matrix_sym", "explicit")] = (ms, bound[0])
    Kx = km.kernel_matrix_sym(X, **kw)
    rows = list(N_SAMPLE_ROWS)
    sampled = _check_close(f"kernel_matrix_sym chi-squared {m}x{d}, rows {rows}",
                           Kx[rows], km.kernel_matrix_rect_plain(X[rows], X, **kw))[0]
    columns = [int(j) for j in np.linspace(0, m - 1, MC_CLASSES)]
    got, plain = entry_errors(lambda _X, V, **_kw: Kx @ V, X, columns, kw["gamma"])
    log("explicit", f"kernel_matrix_sym chi-squared f32 at chi2-width's {m}x{d} "
        f"({Kx.numel() * 4 / 1e9:.1f} GB): {ms:.3f} ms, bound {bound[0]:.3f} ms "
        f"({bound[1]}), {bound[0] / ms:.3f} of it; rows {rows} against the plain version "
        f"max|err| {sampled:.3e}; per entry, {MC_CLASSES} columns of K: worst rel err "
        f"{got:.3e}, plain f32 {plain:.3e} ({got / plain:.2f}x)")
    if not got <= min(4 * plain, 1e-4):
        raise AssertionError(f"kernel_matrix_sym per-entry error {got}, plain f32 {plain}")
    del Kx
    torch.cuda.empty_cache()
    # the same build in float64: the double instantiation, the divide-free
    # quotient on these rows
    X64 = X.double()
    bound = _n_bound(m, m, d, "chi_squared", 8, 8, True)
    ms = _median_ms(lambda: km.kernel_matrix_sym(X64, **kw), 1, 1)
    main_ms[("kernel_matrix_sym_f64", "explicit")] = (ms, bound[0])
    _log_bound("kernel_matrix_sym", f"{m}x{d} f64 chi-squared ({m * m * 8 / 1e9:.1f} GB)",
               ms, bound)
    del X, X64
    torch.cuda.empty_cache()
    # config 2's laplacian K, whole, as the -t 4 CLI fit builds it
    train = port.DataSet(config2_files[0][0], dtype=np.float32)
    Xl = torch.as_tensor(np.asarray(train.data)[:-1], device="cuda")
    m, d = Xl.shape
    kw_l = dict(kind=K.LAPLACIAN, gamma=1.0 / d)
    label = f"{m}x{d} f32 laplacian (config 2)"
    main_err[lap_key] = _check_close(f"kernel_matrix_sym {label}",
                                     km.kernel_matrix_sym(Xl, **kw_l),
                                     km.kernel_matrix_sym_plain(Xl, **kw_l))[0]
    timing[lap_key] = _time_pair(
        "kernel_matrix_sym", km.kernel_matrix_sym, km.kernel_matrix_sym_plain, (Xl,), kw_l,
        m * (m + 1) / 2 * d, label, plain_repeats=DIST_PLAIN_REPEATS,
        unit="T pair-features/s", counted="m (m + 1) / 2 d")
    bounds[lap_key] = _n_bound(m, m, d, "laplacian", 4, 4, True)
    _log_bound("kernel_matrix_sym", label, timing[lap_key][0], bounds[lap_key])
    main_ms[("kernel_matrix_sym_laplacian", "explicit")] = (timing[lap_key][0],
                                                            bounds[lap_key][0])
    log("explicit", f"kernel_matrix_sym {label}: the whole K against the plain version, "
        f"max|err| {main_err[lap_key]:.3e}")
    del Xl, train
    # the ring's row block of the chi2-cli cell, K_p = k(X_p, X) for p = 0,
    # is built one column block k(X_p, X_q) a shard q (as a process of a
    # multi-process ring builds it while the shards come round): the
    # block of q = 1 is checked and timed, the per-entry check runs over
    # every column
    train, _ = chi2_cell["make"](np.float32)
    Xc = torch.as_tensor(np.asarray(train.data)[:-1], device="cuda")
    shards = sharded.shard_bounds(Xc.shape[0], RING_SHARDS)
    Xp, Xq = Xc[shards[0][0]:shards[0][1]], Xc[shards[1][0]:shards[1][1]]
    kw_c = dict(kind=K.CHI_SQUARED, gamma=chi2_cell["params"]["gamma"])
    label = f"{Xp.shape[0]}x{Xq.shape[0]}x{Xc.shape[1]}"
    main_err[rect_key] = _check_close(f"kernel_matrix_rect chi-squared {label}",
                                      km.kernel_matrix_rect(Xp, Xq, **kw_c),
                                      km.kernel_matrix_rect_plain(Xp, Xq, **kw_c))[0]
    got, plain = entry_errors(
        lambda P, S, V, **_kw: km.kernel_matrix_rect(P, S, **kw_c) @ V, Xc,
        [int(j) for j in np.linspace(0, Xc.shape[0] - 1, MC_CLASSES)], kw_c["gamma"],
        points=Xp)
    if not got <= min(4 * plain, 1e-4):
        raise AssertionError(f"kernel_matrix_rect per-entry error {got}, plain f32 {plain}")
    bounds[rect_key] = _n_bound(Xp.shape[0], Xq.shape[0], Xc.shape[1], "chi_squared", 4, 4,
                                False)
    timing[rect_key] = _time_pair(
        "kernel_matrix_rect", km.kernel_matrix_rect, km.kernel_matrix_rect_plain, (Xp, Xq),
        kw_c, float(Xp.shape[0]) * Xq.shape[0] * Xc.shape[1], f"{label} f32 chi-squared",
        plain_repeats=DIST_PLAIN_REPEATS, unit="T pair-features/s", counted="mr mc d")
    _log_bound("kernel_matrix_rect", label, timing[rect_key][0], bounds[rect_key])
    main_ms[("kernel_matrix_rect", "explicit")] = (timing[rect_key][0], bounds[rect_key][0])
    log("explicit", f"kernel_matrix_rect per entry at the ring's row block: worst rel "
        f"err {got:.3e}, plain f32 {plain:.3e}")
    # the kernels phase's shape, beside the plain version
    Xt = _zero_rich(N_TIMING_M, N_TIMING_D, torch.float32, gen)
    kw_t = dict(kind=K.CHI_SQUARED, gamma=1.0 / N_TIMING_D)
    label = f"m={N_TIMING_M} d={N_TIMING_D} f32 chi-squared"
    timing[sym_key] = _time_pair(
        "kernel_matrix_sym", km.kernel_matrix_sym, km.kernel_matrix_sym_plain, (Xt,), kw_t,
        N_TIMING_M * (N_TIMING_M + 1) / 2 * N_TIMING_D, label,
        plain_repeats=DIST_PLAIN_REPEATS, unit="T pair-features/s", counted="m (m + 1) / 2 d")
    bounds[sym_key] = _n_bound(N_TIMING_M, N_TIMING_M, N_TIMING_D, "chi_squared", 4, 4, True)
    _log_bound("kernel_matrix_sym", label, timing[sym_key][0], bounds[sym_key])
    Xt = _zero_rich(N_TIMING_M_F64, N_TIMING_D, torch.float64, gen)
    label = f"m={N_TIMING_M_F64} d={N_TIMING_D} f64 chi-squared"
    timing[f64_key] = _time_pair(
        "kernel_matrix_sym", km.kernel_matrix_sym, km.kernel_matrix_sym_plain, (Xt,), kw_t,
        N_TIMING_M_F64 * (N_TIMING_M_F64 + 1) / 2 * N_TIMING_D, label, plain_repeats=1,
        unit="T pair-features/s", counted="m (m + 1) / 2 d")
    bounds[f64_key] = _n_bound(N_TIMING_M_F64, N_TIMING_M_F64, N_TIMING_D, "chi_squared", 8,
                               8, True)
    _log_bound("kernel_matrix_sym", label, timing[f64_key][0], bounds[f64_key])
    main_err[sym_key] = sampled
    return main_err, timing, bounds, main_ms


def _explicit_fit(label, svm, train, test, labels, implicit, epsilon, need, **fit_kw):
    """Fit ``train`` with ``svm`` (``solver="cg_explicit"``) and predict
    ``test``; log build ms, s/iteration, iterations, fit s and accuracy
    beside the implicit fit's, and raise unless the solver was explicit, the
    model finite and the labels agree with the implicit fit's on ``need``
    of the points.  Returns the predicted labels."""
    import plssvm_tpu_torch as port

    port.global_tracker.clear()
    t0 = time.perf_counter()
    model = svm.fit(train, epsilon=epsilon, **fit_kw)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    predicted = svm.predict(model, test)
    iterations = _tracked("cg", "iterations")
    build_ms = _tracked("cg", "kernel_matrix_build_time")
    # the tracker's CG runtime holds the build, as plssvm_tpu's does
    s_per_it = (_tracked("cg", "total_runtime") - build_ms) / 1000 / max(iterations, 1)
    accuracy = float(np.mean(predicted == labels))
    agree = float(np.mean(predicted == implicit["predicted"]))
    log("explicit", f"{label} cg_explicit: build {build_ms:.3f} ms, {iterations} CG "
        f"iterations at {s_per_it:.6f} s/iteration (the build excluded; CG and build "
        f"{_tracked('cg', 'total_runtime') / 1000:.3f} s), fit {t1 - t0:.3f} s, accuracy "
        f"{accuracy:.4f}; cg_implicit: {implicit['iterations']} at {implicit['s_per_it']:.6f}"
        f" s/iteration, fit {implicit['fit_s']:.3f} s, accuracy {implicit['accuracy']:.4f}; "
        f"label agreement {agree:.4f}")
    if _tracked("cg", "solver") != "cg_explicit":
        raise AssertionError(f"explicit {label}: the fit resolved to {_tracked('cg', 'solver')}")
    if not (np.all(np.isfinite(model.alpha)) and np.all(np.isfinite(model.rho))):
        raise AssertionError(f"explicit {label}: non-finite model")
    if agree < need:
        raise AssertionError(f"explicit {label}: label agreement {agree} below {need}")
    return predicted


def _cli_explicit(tmp, label, train_file, test_file, labels, implicit_predicted, flags):
    """``plssvm-torch-train --solver cg_explicit`` and the predict CLI on a
    CLI phase's files, against that phase's (implicit) labels."""
    fit_s, predict_s, predicted, io = _cli_fit_predict(
        f"explicit-{label}", train_file, test_file, tmp, flags, solver="cg_explicit")
    agree = float(np.mean(predicted == implicit_predicted))
    build_ms = _tracked("cg", "kernel_matrix_build_time")
    iterations = _tracked("cg", "iterations")
    s_per_it = (_tracked("cg", "total_runtime") - build_ms) / 1000 / max(iterations, 1)
    log("explicit", f"{label} through plssvm-torch-train --solver cg_explicit: build "
        f"{build_ms:.3f} ms, {iterations} CG iterations at {s_per_it:.6f} s/iteration (the "
        f"build excluded), fit "
        f"(CLI) {fit_s:.3f} s (file I/O {io['fit_parse']:.3f}), predict {predict_s:.3f} s, "
        f"accuracy {np.mean(predicted == labels):.4f}, label agreement with the implicit "
        f"run {agree:.4f}")
    if agree < 0.995:
        raise AssertionError(f"explicit {label}: label agreement {agree} below 0.995")


def phase_explicit(tmp, config2_files, e2e_predicted, ring_cells, chi2_width):
    """The explicit solver (``solver="cg_explicit"``) on the card.

    (a) kernel N against its plain version (``_kernel_n_checks``); (b) at
    the main paths' shapes and at 16384 x 256, timed beside the bound
    (``_kernel_n_main_shapes``); (c) with the counts set to 0: fits with
    ``cg_explicit`` beside the same fit with ``cg_implicit`` (chi2-width's
    10 histogram classes through ``CSVM``, phase 10's fit; the MNIST-width
    10 classes, phase 7's; config 2 and its laplacian files through
    ``plssvm-torch-train --solver cg_explicit``, phases 4 and 8; config 2 in
    float64 at epsilon 1e-10, both solvers here): label agreement >= 0.995
    in float32 and >= 0.999 in float64, each logging build ms,
    s/iteration, iterations and accuracy; chi2-width's float32 fit also
    >= 0.995 with its own float64 fit at 1e-10, whose cached K is checked against
    the plain version (``_check_f64_build``); (d) the ring's explicit path,
    four shards on cuda:0, on phase 9's histogram classes against the
    one-device explicit fit (>= 0.995, float32); (e) kernel N's launches:
    the symmetric walk once per distance fit of (c), counted per type and
    kind, the rectangular one once per shard in (d), the implicit products
    never; (f) after them, ``automatic`` at the budget's edge
    (``_budget_edge``).
    """
    import plssvm_tpu_torch as port
    from plssvm_tpu_torch.ops import distance, gram_matmat, gram_matvec
    from plssvm_tpu_torch.ops import kernel_matrix as km

    gen = torch.Generator().manual_seed(SEED + 31)
    worst = _kernel_n_checks(gen)
    main_err, timing, bounds, main_ms = _kernel_n_main_shapes(gen, chi2_width,
                                                               ring_cells["chi2"], config2_files)

    (train_file, _), (test_file, test_labels) = config2_files
    # config 2 in float64: the implicit fit at epsilon 1e-10 to compare with
    train64 = port.DataSet(train_file, dtype=np.float64)
    test64 = port.DataSet(test_file, dtype=np.float64)
    svm = port.CSVM(backend="cuda", device="cuda", dtype=np.float64, kernel_type="rbf",
                    cost=1.0, solver="cg_implicit")
    port.global_tracker.clear()
    t0 = time.perf_counter()
    model = svm.fit(train64, epsilon=RING_F64_EPSILON)
    t1 = time.perf_counter()
    predicted = svm.predict(model, test64)
    implicit64 = dict(predicted=predicted, fit_s=t1 - t0, iterations=_tracked("cg", "iterations"),
                      s_per_it=_tracked("cg", "avg_iteration_time") / 1000,
                      accuracy=float(np.mean(predicted == test_labels)))

    for module in (gram_matvec, gram_matmat, distance, km):
        module.reset_counts()
    # chi2-width: kernel N's symmetric walk, then K @ V on the stored K, in
    # float32 beside phase 10's fit, then in float64 to 1e-10, the answer
    # both float32 fits approach
    kw = dict(backend="cuda", device="cuda", kernel_type="chi_squared",
              gamma=chi2_width["gamma"], cost=1.0, solver="cg_explicit")
    train = chi2_width["train"]
    predicted = _explicit_fit(
        f"chi2-width {MC_CLASSES} classes f32", port.CSVM(dtype=np.float32, **kw), train,
        chi2_width["test"], chi2_width["labels"], chi2_width["implicit"], CHI_WIDTH_EPSILON,
        0.995, max_iter=chi2_width["max_iter"])
    train._k_cache = None
    # kernel N's symmetric launches per type and kind: float32 chi-squared
    # here, float64 chi-squared and float32 laplacian below
    sym = {"kernel_matrix_sym": km.sym_launches}
    chi_train64 = port.DataSet(np.asarray(train.data), np.asarray(train.labels), dtype=np.float64)
    chi_test64 = port.DataSet(np.asarray(chi2_width["test"].data),
                          np.asarray(chi2_width["test"].labels), dtype=np.float64)
    svm = port.CSVM(dtype=np.float64, **kw)
    port.global_tracker.clear()
    t0 = time.perf_counter()
    model = svm.fit(chi_train64, epsilon=RING_F64_EPSILON)
    t1 = time.perf_counter()
    predicted64 = svm.predict(model, chi_test64)
    agree = [float(np.mean(labels == predicted64))
             for labels in (predicted, chi2_width["implicit"]["predicted"])]
    build_ms = _tracked("cg", "kernel_matrix_build_time")
    s_per_it = (_tracked("cg", "total_runtime") - build_ms) / 1000 / max(model.n_iter, 1)
    log("explicit", f"chi2-width {MC_CLASSES} classes f64 cg_explicit to {RING_F64_EPSILON}: "
        f"build {build_ms:.3f} ms, {model.n_iter} CG iterations at {s_per_it:.6f} "
        f"s/iteration (the build excluded), fit "
        f"{t1 - t0:.3f} s, accuracy {np.mean(predicted64 == chi2_width['labels']):.4f}; label "
        f"agreement with the f32 explicit fit {agree[0]:.4f}, with the f32 implicit fit "
        f"{agree[1]:.4f}")
    if agree[0] < 0.995:
        raise AssertionError(f"explicit chi2-width: the f32 and f64 explicit fits agree on "
                             f"{agree[0]}")
    sym["kernel_matrix_sym_f64"] = km.sym_launches - sum(sym.values())
    plain_before = km.plain_calls
    main_err[("kernel_matrix_sym", "f64")] = max(
        _check_f64_build(chi_train64, chi2_width["gamma"]), worst[("kernel_matrix_sym", "f64")])
    checks_plain = km.plain_calls - plain_before
    del chi_train64, chi_test64, svm, model
    torch.cuda.empty_cache()
    # MNIST width: the Gram build (cuBLAS, TF32) and K @ V
    cell = ring_cells["mnist-width"]
    train, test = cell["make"](np.float32)
    svm = port.CSVM(backend="cuda", device="cuda", dtype=np.float32, kernel_type="rbf",
                    cost=1.0, solver="cg_explicit")
    _explicit_fit(f"mnist-width {MC_CLASSES} classes rbf f32", svm, train, test,
                  cell["labels"], cell["implicit"], EPSILON, 0.995)
    del train, test, svm
    torch.cuda.empty_cache()
    # config 2 and its laplacian files through the CLIs
    _cli_explicit(tmp, "config 2 rbf", train_file, test_file, test_labels, e2e_predicted,
                  ["-t", "2", "-c", "1", "-e", str(EPSILON)])
    _cli_explicit(tmp, "config 2 -t 4", train_file, test_file, test_labels,
                  ring_cells["laplacian"]["predicted"],
                  ["-t", "4", "-c", "1", "-e", str(EPSILON)])
    sym["kernel_matrix_sym_laplacian"] = km.sym_launches - sum(sym.values())
    # config 2 in float64 (the Gram build in DGEMM)
    svm = port.CSVM(backend="cuda", device="cuda", dtype=np.float64, kernel_type="rbf",
                    cost=1.0, solver="cg_explicit")
    _explicit_fit("config 2 rbf f64 (epsilon 1e-10)", svm, train64, test64, test_labels,
                  implicit64, RING_F64_EPSILON, 0.999)
    del train64, test64
    implicit_products = (gram_matvec.sym_tc_launches + gram_matvec.sym_launches
                         + gram_matvec.sym_dmma_launches + gram_matmat.sym_tc_launches
                         + gram_matmat.sym_launches + distance.matvec_sym_launches
                         + distance.matmat_sym_launches)
    log("explicit", f"kernel N symmetric walk launches {km.sym_launches}: chi2-width f32 "
        f"{sym['kernel_matrix_sym']}, f64 {sym['kernel_matrix_sym_f64']}, the laplacian CLI "
        f"fit {sym['kernel_matrix_sym_laplacian']}; rectangular {km.rect_launches}, plain "
        f"builds {km.plain_calls - checks_plain} (and {checks_plain} for the float64 check); "
        f"implicit symmetric products {implicit_products}")
    if set(sym.values()) != {1} or km.sym_launches != 3 or km.rect_launches \
            or km.plain_calls != checks_plain or implicit_products:
        raise AssertionError("explicit: the fits did not build K through kernel N once each, "
                             "or ran an implicit product")

    # (d) the ring's explicit path, four shards on cuda:0
    cell = ring_cells["chi2"]
    train, test = cell["make"](np.float32)
    one = _ring_run(cell, train, test, np.float32, cell["epsilon"], None, "cg_explicit")
    one_sym = km.sym_launches
    train, test = cell["make"](np.float32)
    ring = _ring_run(cell, train, test, np.float32, cell["epsilon"],
                     ["cuda:0"] * RING_SHARDS, "cg_explicit")
    rect_launches = km.rect_launches
    agree = float(np.mean(ring["predicted"] == one["predicted"]))
    log("explicit", f"ring {RING_SHARDS} shards on cuda:0, {MC_CLASSES} histogram classes "
        f"f32 cg_explicit: {ring['iterations']} iterations at {ring['s_per_it']:.6f} "
        f"s/iteration (one device {one['iterations']} at {one['s_per_it']:.6f}), fit "
        f"{ring['fit_s']:.3f} s (one device {one['fit_s']:.3f}), accuracy "
        f"{ring['accuracy']:.4f}, label agreement with one device {agree:.4f}; kernel N rect "
        f"launches {rect_launches} (a column block a shard and shard; one device: sym "
        f"{one_sym}); ring products {ring['counts'][1]}")
    if rect_launches != RING_SHARDS ** 2 or one_sym != 1 or ring["counts"][1][:2] != [0, 0] \
            or not ring["converged"] or agree < 0.995:
        raise AssertionError("explicit: the ring's explicit fit did not build its row "
                             "blocks through kernel N or disagrees with one device")
    launches = {**sym, "kernel_matrix_rect": rect_launches}
    del train, test, one, ring
    # (f) the budget's edge, after the counted launches
    _budget_edge()
    for key in main_err:
        if key not in (("kernel_matrix_sym", "f64"), ("kernel_matrix_sym", "laplacian")):
            main_err[key] = max(main_err[key], worst[(key[0], "f32")])
    return launches, (main_err, timing, bounds, main_ms)


def _check_f64_build(train64, gamma):
    """The float64 chi-squared K that the explicit fit of ``train64``
    cached (59999 x 784, 28.8 GB): N_SAMPLE_ROWS against the plain
    version in float64 within F64_TOL, and per entry, every 8th row and
    N_SAMPLE_ROWS at 10 columns, against long double within 2x the float64
    plain version's error (as kernels E-H in float64).  Returns the
    sampled rows' max|err|."""
    from plssvm_tpu_torch.ops import kernel_matrix as km
    from plssvm_tpu_torch.ops.entry_check import chi2_f64_in_range, entry_errors
    from plssvm_tpu_torch.parameter import KernelFunctionType as K

    K64 = train64._k_cache[1]
    X = torch.as_tensor(np.asarray(train64.data)[:-1], device="cuda")
    m, d = X.shape
    if K64.shape != (m, m) or K64.dtype != torch.float64:
        raise AssertionError(f"the float64 fit cached a {K64.dtype} {tuple(K64.shape)} K")
    kw = dict(kind=K.CHI_SQUARED, gamma=gamma)
    rows = list(N_SAMPLE_ROWS)
    sampled = _check_close(f"kernel_matrix_sym f64 chi-squared {m}x{d}, rows {rows}",
                           K64[rows], km.kernel_matrix_rect_plain(X[rows], X, **kw))[0]
    index = torch.tensor(sorted(set(range(0, m, 8)) | set(rows)), device="cuda")
    columns = [int(j) for j in np.linspace(0, m - 1, MC_CLASSES)]
    got, plain = entry_errors(lambda P, S, V, **_kw: K64[index] @ V, X, columns, gamma,
                              points=X[index])
    log("explicit", f"kernel_matrix_sym f64 chi-squared, the fit's {m}x{d} K "
        f"({K64.numel() * 8 / 1e9:.1f} GB; the rows "
        f"{'within' if chi2_f64_in_range(X) else 'outside'} the divide-free range): rows "
        f"{rows} against the plain version max|err| {sampled:.3e}; per entry, {len(index)} "
        f"rows x {MC_CLASSES} columns against long double: worst rel err {got:.3e}, plain "
        f"f64 {plain:.3e} ({got / plain:.2f}x)")
    if not got <= 2 * plain:
        raise AssertionError(f"kernel_matrix_sym f64 per-entry error {got}, plain {plain}")
    return sampled


def _budget_edge():
    """``solver="automatic"`` at the explicit budget's edge: the most rows
    m (EDGE_D features, float32) whose K the budget admits, about 80 GB.
    (within EDGE_SLACK).
    A laplacian fit resolves to ``cg_explicit`` and runs; a second one on
    the same data set with another gamma runs too, which it can only if
    the cached K goes before the next is built; an RBF fit forced to
    ``cg_explicit`` there builds through cuBLAS in row blocks.  Each logs
    its build, the peak of allocated memory against the card's and what
    the budget left; at m + 1024 rows ``automatic`` takes ``cg_implicit``."""
    import plssvm_tpu_torch as port
    from plssvm_tpu_torch.parameter import KernelFunctionType as K

    torch.cuda.empty_cache()
    dev = torch.device("cuda", torch.cuda.current_device())
    total = torch.cuda.get_device_properties(dev).total_memory
    probe = port.CSVM(backend="cuda", device="cuda", dtype=np.float32, kernel_type="laplacian")
    m = math.isqrt(probe._explicit_budget(dev, 0, EDGE_D, 1) // 4)
    while (probe._explicit_k_bytes(m, m)
           > probe._explicit_budget(dev, m, EDGE_D, 1) - EDGE_SLACK):
        m -= 64
    rng = np.random.default_rng(SEED + 41)
    X = rng.standard_normal((m + 1, EDGE_D)).astype(np.float32)
    y = np.where(X[:, 0] + 0.5 * rng.standard_normal(m + 1) > 0, 1, -1)
    train = port.DataSet(X, y, dtype=np.float32)
    budget = probe._explicit_budget(dev, m, EDGE_D, 1, train)
    log("explicit", f"budget edge: {m} rows x {EDGE_D}, K {probe._explicit_k_bytes(m, m)} "
        f"bytes, budget {budget} bytes of {total}")
    for label, params in (("laplacian automatic", dict(kernel_type="laplacian")),
                          ("laplacian automatic, gamma / 2",
                           dict(kernel_type="laplacian", gamma=0.5 / EDGE_D)),
                          ("rbf cg_explicit", dict(kernel_type="rbf", solver="cg_explicit"))):
        svm = port.CSVM(backend="cuda", device="cuda", dtype=np.float32, cost=1.0, **params)
        torch.cuda.reset_peak_memory_stats(dev)
        port.global_tracker.clear()
        t0 = time.perf_counter()
        model = svm.fit(train, epsilon=1e-3, max_iter=EDGE_MAX_ITER)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        log("explicit", f"budget edge, {label}: {_tracked('cg', 'solver')}, build "
            f"{_tracked('cg', 'kernel_matrix_build_time'):.3f} ms, {model.n_iter} iterations, "
            f"fit {time.perf_counter() - t0:.3f} s; peak allocated {peak} bytes, "
            f"{total - peak} of the card's {total} left")
        if _tracked("cg", "solver") != "cg_explicit" \
                or not np.all(np.isfinite(model.alpha)):
            raise AssertionError(f"budget edge {label}: not an explicit fit, or non-finite")
        del svm, model
    over = probe._use_explicit_solver(m + 1024, EDGE_D, K.LAPLACIAN, data=train)
    log("explicit", f"budget edge: at {m + 1024} rows automatic takes "
        f"{'cg_explicit' if over else 'cg_implicit'}")
    if over:
        raise AssertionError("budget edge: automatic took cg_explicit past the budget")
    del train
    torch.cuda.empty_cache()


def phase_stall(chi2_cell):
    """ROADMAP Queue 3 item 2's case: phase 9's 10 histogram classes in
    float32 to epsilon 1e-8 with Jacobi, STALL_RUNS fits with each solver,
    max_iter STALL_MAX_ITER: the iterations per class of every run and the
    runs where a class stopped at the cap.  Every product sums across
    blocks in a fixed order (csrc/fixed_sum.cuh), so every run must give
    the first run's iterations per class, with either solver."""
    import plssvm_tpu_torch as port

    train, _ = chi2_cell["make"](np.float32)
    for solver in ("cg_implicit", "cg_explicit"):
        svm = port.CSVM(backend="cuda", device="cuda", dtype=np.float32, cost=1.0,
                        preconditioner="jacobi", solver=solver, **chi2_cell["params"])
        stalls, start, first = 0, time.perf_counter(), None
        for run in range(STALL_RUNS):
            port.global_tracker.clear()
            model = svm.fit(train, epsilon=1e-8, max_iter=STALL_MAX_ITER)
            per_class = _tracked("cg", "iterations_per_class")
            stalled = [c for c, n in enumerate(per_class) if n >= STALL_MAX_ITER]
            stalls += bool(stalled)
            log("stall", f"{solver} run {run + 1}: {model.n_iter} block iterations, per class "
                f"{per_class}, classes at the cap {stalled or 'none'}")
            first = per_class if first is None else first
            if per_class != first:
                raise AssertionError(f"stall: {solver} run {run + 1} took {per_class} "
                                     f"iterations per class, run 1 {first}")
        log("stall", f"{solver}: {STALL_RUNS} runs, each {first} iterations per class; "
            f"{stalls} stalled (a class at the cap of {STALL_MAX_ITER}), "
            f"{time.perf_counter() - start:.3f} s")


#: ``--chi2-width-agreement``: chi2-width's fits (label, type, solver,
#: epsilon), each capped at STUDY_MAX_ITER block iterations
STUDY_RUNS = (
    ("implicit f32 1e-7 (a)", np.float32, "cg_implicit", 1e-7),
    ("implicit f32 1e-7 (b)", np.float32, "cg_implicit", 1e-7),
    ("explicit f32 1e-7", np.float32, "cg_explicit", 1e-7),
    ("implicit f32 1e-8", np.float32, "cg_implicit", 1e-8),
    ("explicit f32 1e-8", np.float32, "cg_explicit", 1e-8),
    ("explicit f64 1e-10", np.float64, "cg_explicit", 1e-10),
)
STUDY_MAX_ITER = 400


def _chi2_width_products(X, gamma):
    """One product of each float32 path at chi2-width (X the 59999 train
    rows) against float64: V (m, 10) seeded normal; the reference K64 @ V
    in float64, K64 from kernel N in float64; the implicit product (kernel
    G), the explicit one (``explicit_product`` on kernel N's float32 K:
    cuBLAS on slices of PRODUCT_ROWS rows), the same K in one cuBLAS
    call, in full float32 and with TF32 on, and the stored float32 K's
    product in float64 (its entries' error alone).  Logs each one's
    relative error in the Frobenius norm and the float32 products' ms
    (median of 5); returns {name: (rel err, ms or None)}."""
    from plssvm_tpu_torch.ops import distance
    from plssvm_tpu_torch.ops import kernel_matrix as km
    from plssvm_tpu_torch.parameter import KernelFunctionType as K
    from plssvm_tpu_torch.solver.explicit import _tf32, explicit_product

    kw = dict(kind=K.CHI_SQUARED, gamma=gamma)
    X32 = torch.as_tensor(X, dtype=torch.float32, device="cuda")
    gen = torch.Generator().manual_seed(SEED + 43)
    V64 = torch.randn(X32.shape[0], MC_CLASSES, generator=gen, dtype=torch.float64).to("cuda")
    V32 = V64.float()
    K64 = km.kernel_matrix_sym(X32.double(), **kw)
    ref = K64 @ V64
    del K64
    torch.cuda.empty_cache()
    K32 = km.kernel_matrix_sym(X32, **kw)
    rows = 4096
    stored = torch.cat([K32[i:i + rows].double() @ V64 for i in range(0, K32.shape[0], rows)])

    def one_call(tf32):
        with _tf32(tf32):
            return K32 @ V32

    products = {
        "implicit (kernel G)": lambda: distance.distance_matmat_sym(X32, V32, **kw),
        "explicit (explicit_product)": lambda: explicit_product(K32, V32, torch.float32,
                                                                symmetric=True),
        "the float32 K in one cuBLAS call": lambda: one_call(False),
        "the float32 K in one cuBLAS call, TF32 on": lambda: one_call(True),
    }
    found = {}
    for name, product in products.items():
        err = float(torch.linalg.norm(product().double() - ref) / torch.linalg.norm(ref))
        found[name] = (err, _median_ms(product, 5, 1))
    found["the stored float32 K in float64"] = (
        float(torch.linalg.norm(stored - ref) / torch.linalg.norm(ref)), None)
    for name, (err, ms) in found.items():
        log("chi2-agreement", f"one product at {X32.shape[0]}x{X32.shape[1]}, C = {MC_CLASSES}:"
            f" {name} rel err {err:.3e} against float64"
            + ("" if ms is None else f", {ms:.3f} ms"))
    del K32
    torch.cuda.empty_cache()
    return found


def phase_chi2_width_agreement():
    """How far two solves of chi2-width (phase 10's data) agree: first one
    product of each path against float64 (``_chi2_width_products``), then
    the fits of STUDY_RUNS, each logging its block iterations, iterations
    per class, whether it reached epsilon, fit seconds and accuracy, then
    the label agreement of every pair.  Two implicit float32 fits at 1e-7 read
    the floor that two float32 solves of this cell reach; the float32 fits
    at 1e-8 whether either solver fails there.  Returns the JSON-able
    record."""
    import plssvm_tpu_torch as port

    X, y, X_test, y_test, gamma, bayes, made_s = _chi2_width_data()
    log("chi2-agreement", f"made the data in {made_s:.2f} s; gamma {gamma:.6f}, Bayes-optimal "
        f"accuracy {bayes:.4f}; max_iter {STUDY_MAX_ITER}")
    products = _chi2_width_products(X[:-1], gamma)
    sets = {dtype: (port.DataSet(X, y, dtype=dtype), port.DataSet(X_test, y_test, dtype=dtype))
            for dtype in (np.float32, np.float64)}
    record = {"products": products, "runs": [], "agreement": {}}
    predicted = {}
    for label, dtype, solver, epsilon in STUDY_RUNS:
        train, test = sets[dtype]
        svm = port.CSVM(backend="cuda", device="cuda", dtype=dtype, kernel_type="chi_squared",
                        gamma=gamma, cost=1.0, solver=solver)
        port.global_tracker.clear()
        t0 = time.perf_counter()
        model = svm.fit(train, epsilon=epsilon, max_iter=STUDY_MAX_ITER)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        predicted[label] = svm.predict(model, test)
        train._k_cache = None
        run = dict(label=label, iterations=model.n_iter,
                   per_class=_tracked("cg", "iterations_per_class"),
                   reached=bool(_tracked("cg", "residuum") <= _tracked("cg", "target_residuum")),
                   fit_s=fit_s, accuracy=float(np.mean(predicted[label] == y_test)))
        record["runs"].append(run)
        log("chi2-agreement", f"{label}: {run['iterations']} block iterations (per class "
            f"{run['per_class']}), reached epsilon {run['reached']}, fit {fit_s:.3f} s, "
            f"accuracy {run['accuracy']:.4f}")
        del svm, model
        torch.cuda.empty_cache()
    labels = [run[0] for run in STUDY_RUNS]
    for i, a in enumerate(labels):
        for b in labels[i + 1:]:
            agree = float(np.mean(predicted[a] == predicted[b]))
            record["agreement"][f"{a} / {b}"] = agree
            log("chi2-agreement", f"label agreement {a} / {b}: {agree:.4f}")
    return record


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


def _ring_copy_ms(X, iteration_s, label, precision="f32"):
    """The operand copies of the ring at the tier on one shard of X, logged
    beside the iteration: each shard's copy (``tier_operand``; "highest" the
    split stack) made once per solve for its symmetric product and the dual
    walks it takes part in (``sharded.shard_operands``), and per iteration
    the rectangular tile's copies of both operands of the rows-only walk
    (for even P), which ``gram_matvec_rect`` makes per call."""
    from plssvm_tpu_torch.ops import gram_matvec
    from plssvm_tpu_torch.parallel import sharded

    lo, hi = sharded.shard_bounds(X.shape[0], RING_SHARDS)[0]
    shard = X[lo:hi]
    tc = _median_ms(lambda: gram_matvec.tier_operand(shard, precision), 5, 1)
    once = RING_SHARDS * tc
    per_it = RING_SHARDS * 2 * (RING_SHARDS % 2 == 0) * tc
    log("ring", f"{label} {precision}: operand copies once per solve {once:.3f} ms "
        f"({RING_SHARDS} shards x tier_operand of {tc:.3f} ms, for the symmetric product "
        f"and the dual walks), per iteration {per_it:.3f} ms (the rows-only walk's two "
        f"copies a shard), {per_it / 1000 / iteration_s:.3%} of the iteration")


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


def _ring_counts(kind, matmat, dtype, precision="f32"):
    """(dual kernel's name, [symmetric, dual, rows-only launches], launches
    on the tiles the run must not take, plain calls) since the last reset:
    float32 Gram products on the tensor-core tiles at the tier (at
    "highest" three TF32 passes; J there on its matvec walk), none on the
    FFMA tiles (K's included); float64 ones on the DMMA tiles (symmetric,
    dual, rect), none on the FFMA tiles."""
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
    if dtype == np.float32 and not matmat and precision not in ("f32", "bf16"):
        # J at "highest": its matvec walk beside the split sym and rect tiles
        counts = [module.sym_tc_launches, module.dual_launches, module.rect_tc_launches]
        other = module.sym_launches + module.dual_tc_launches + module.rect_launches
    elif dtype == np.float32:
        counts = cores
        other = module.sym_launches + module.dual_launches + module.rect_launches
    else:
        counts = [module.sym_dmma_launches, module.dual_dmma_launches,
                  module.rect_dmma_launches]
        other = (module.sym_launches + module.dual_launches + module.rect_launches
                 + sum(cores))
    return f"gram_{op}_dual", counts, other, plain


def _ring_run(cell, train, test, dtype, epsilon, devices, solver="cg_implicit",
              precision="f32"):
    """Fit ``train`` to ``epsilon`` with ``solver`` at the Gram tier
    ``precision`` and predict ``test`` of a cell in ``dtype`` on
    ``devices`` (None: one device, cuda:0); the counts of its launches from
    the fit on."""
    import plssvm_tpu_torch as port
    from plssvm_tpu_torch.ops import distance, gram_matmat, gram_matvec, kernel_matrix

    where = dict(device="cuda") if devices is None else dict(devices=devices)
    svm = port.CSVM(backend="cuda", dtype=dtype, cost=1.0, solver=solver,
                    gram_precision=precision, **where, **cell["params"])
    for module in (gram_matvec, gram_matmat, distance, kernel_matrix):
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
        counts=_ring_counts(kind, values.ndim == 2, dtype, precision))


def phase_ring(cells):
    """The row-sharded ring on one card: ``CSVM(devices=["cuda:0"] * 4)``
    fits and predicts each cell (binary RBF at config 3's width: A, J, B;
    the 10 Gaussian classes at MNIST width: C, K, D; laplacian on config
    2's files: E, L, F; the 10 histogram classes at config 2's shape with
    chi-squared: G, M, H) in float32 (the default path: A-D, J and K on the
    tensor-core tiles at "f32") and in float64 (A-D, J and K on the DMMA
    tiles, none on the FFMA tiles), and the two Gram cells also in float32
    at ``gram_precision="highest"`` (A-D and K on the tensor-core tiles in
    three TF32 passes over the split operands, J on its matvec walk, none
    on K's FFMA tile), each beside the same fit on one device at the same
    tier.  Gates, in every run: per
    shard and product one symmetric, one dual and (for even P) one
    rows-only launch and per shard one rectangular launch to predict,
    nothing on another tile or the plain versions, epsilon reached; float32
    (the cell's epsilon) the accuracy floor and label agreement with one
    device >= 0.995 (as float32 against float64 elsewhere: the two float32
    solves round apart: 0.9975-1.0000 on an H100); float64 (epsilon 1e-10,
    both solves converged) label agreement >= 0.999, its decision values'
    largest difference logged; "highest" also its label agreement with the
    float64 ring logged.  Each one-device run: one symmetric launch
    per product (float64 Gram ones on the DMMA tile), no dual walk, nothing
    on another tile or the plain versions.  Returns the launches per phase
    for the cost ranking: "ring" the float32 dual walks and the distance
    cells' symmetric and rows-only shard products, "ring-f64" the float64
    rings' symmetric, dual and rows-only launches of the fits (DMMA for the
    Gram cells, ``*_f64`` for the distance ones), "ring-one-f64" the
    float64 one-device fits' symmetric launches, "ring-highest" the dual
    walks of the "highest" rings (K on the split dual tile, J on its walk).
    The binary cell is made here, the others come from phases 7-9."""
    launches = {"ring": {}, "ring-f64": {}, "ring-one-f64": {}, "ring-highest": {}}
    devices = ["cuda:0"] * RING_SHARDS
    steps = (RING_SHARDS - 1) // 2
    for label, cell in {"config3-rbf": _config3_rbf_cell(), **cells}.items():
        kind = cell["params"]["kernel_type"]
        gram = kind not in ("laplacian", "chi_squared")
        f64_predicted = None
        runs = [(np.float32, "f32"), (np.float64, "f32")] + (
            [(np.float32, "highest")] if gram else [])
        for dtype, precision in runs:
            data = cell["make"](dtype)
            epsilon = cell["epsilon"] if dtype == np.float32 else RING_F64_EPSILON
            type_name = np.dtype(dtype).name + (" highest" if precision == "highest" else "")
            _automatic("ring", f"{label} {kind} {type_name}", data[0].num_data_points,
                       data[0].num_features, kind, data[0].num_different_labels, dtype,
                       precision=precision, devices=devices)
            one = _ring_run(cell, *data, dtype, epsilon, None, precision=precision)
            ring = _ring_run(cell, *data, dtype, epsilon, devices, precision=precision)
            name, counts, other, plain = ring["counts"]
            products = 1 + ring["iterations"] + ring["iterations"] // 50
            agree = float(np.mean(ring["predicted"] == one["predicted"]))
            dvalue = float(np.max(np.abs(ring["values"] - one["values"])))
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
            if not gram:
                # the fit's symmetric and rows-only shard products, without
                # the predict's rectangular launches; the one-device fit's
                sym, rect = name.replace("dual", "sym"), name.replace("dual", "rect")
                target = launches["ring" if dtype == np.float32 else "ring-f64"]
                target[sym + suffix] = counts[0]
                target[rect + suffix] = counts[2] - RING_SHARDS
                if dtype == np.float64:
                    launches["ring-one-f64"][sym + suffix] = one["counts"][1][0]
            if precision == "highest":
                launches["ring-highest"][name] = counts[1]
                X = torch.as_tensor(np.asarray(data[0].data), device="cuda")
                _ring_copy_ms(X, ring["s_per_it"], label, precision)
                log("ring", f"{label} {kind} highest: label agreement with the float64 ring "
                    f"{float(np.mean(ring['predicted'] == f64_predicted)):.4f}")
            elif dtype == np.float32:
                launches["ring"][name] = counts[1]
                if gram:
                    X = torch.as_tensor(np.asarray(data[0].data), device="cuda")
                    _ring_copy_ms(X, ring["s_per_it"], label)
            else:
                f64_predicted = ring["predicted"]
                launches["ring-f64"][f"{name}_f64"] = counts[1]
                if gram:
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
    # kernel_matvec at f32, bf16 and highest (the tensor-core tile, highest
    # in three TF32 passes) is kernel A's only caller here; rect_full (f32)
    # and rect_full_hi (highest) kernel B's; the FFMA tiles launch no time
    if launches != {"kernel_matvec": 3 * per_variant, "gram_matvec_sym": 0,
                    "gram_matvec_sym_tc": 3 * per_variant,
                    "gram_matvec_rect": 0, "gram_matvec_rect_tc": 2 * per_variant,
                    "distance_matvec_sym": per_variant} \
            or matvec.sym_plain_calls != per_variant \
            or matvec.dist_sym_plain_calls != per_variant:
        raise AssertionError("bench_matvec's variants did not launch as expected")
    return {k: launches[k] for k in ("kernel_matvec", "gram_matvec_sym", "gram_matvec_rect")}


@contextlib.contextmanager
def _numpy_io():
    """Within the block the port's I/O takes its NumPy paths, as with
    ``PLSSVM_TPU_TORCH_NO_NATIVE=1``: the native entry points answer
    'unavailable'."""
    import plssvm_tpu_torch.native as native

    names = ("parse_libsvm_native", "parse_model_svs_native", "parse_arff_data_native",
             "write_libsvm_native", "write_model_native", "write_arff_native")
    saved = {name: getattr(native, name) for name in names}
    for name in names:
        setattr(native, name, (lambda *a, **k: False) if name.startswith("write")
                else (lambda *a, **k: None))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(native, name, fn)


def phase_parse(tmp, config2_files, mc_files):
    """The native parser (``plssvm_tpu_torch/native``, built with g++ at
    first use) against the NumPy path on the CLI phases' files: config 2's
    train and test files and the 10-class files, each parsed both ways in
    float32 (the CLIs' type), bit for bit equal; then a config 2-sized
    model (10000 SVs x 200) written both ways, byte for byte equal but for
    the creation-time line, and re-read both ways; then phase 4's CLI fit
    and predict with the NumPy I/O (the port's only parser before the
    native one), native, native, NumPy, each split into its file I/O and
    the rest.  Logs each path's seconds; fails if the library is missing
    or a native call fell back."""
    import plssvm_tpu_torch as port
    from plssvm_tpu_torch.io import libsvm, model_file
    from plssvm_tpu_torch.io.file_reader import read_lines
    from plssvm_tpu_torch.native import loader

    start = time.perf_counter()
    if not loader.native_available():
        raise AssertionError("parse: the native library is not available (g++ build failed "
                             "or PLSSVM_TPU_TORCH_NO_NATIVE is set)")
    log("parse", f"native library built and loaded in {time.perf_counter() - start:.2f} s "
        f"({loader._cache_dir()})")
    paths = [("config 2 train", config2_files[0][0]), ("config 2 test", config2_files[1][0]),
             (f"{MC_CLASSES}-class train", mc_files["mc_train"][0]),
             (f"{MC_CLASSES}-class test", mc_files["mc_test"][0])]
    for label, path in paths:
        loader.reset_counts()
        t0 = time.perf_counter()
        X, labels = libsvm.parse_libsvm_file(path, dtype=np.float32)
        t1 = time.perf_counter()
        X_np, labels_np = libsvm.parse_libsvm_lines(read_lines(path, comment="#"),
                                                    dtype=np.float32)
        t2 = time.perf_counter()
        if loader.native_parses != 1:
            raise AssertionError(f"parse: {label} did not go through the native parser")
        if not (X.dtype == X_np.dtype and np.array_equal(X, X_np) and labels == labels_np):
            raise AssertionError(f"parse: {label} differs between the native and NumPy paths")
        log("parse", f"{label} {X.shape[0]}x{X.shape[1]} ({os.path.getsize(path) / 1e6:.1f} MB): "
            f"native {t1 - t0:.3f} s, NumPy {t2 - t1:.3f} s ({(t2 - t1) / (t1 - t0):.1f}x), "
            "bit for bit equal")
    # a model of config 2's size: its training rows, random alphas
    X, labels = libsvm.parse_libsvm_file(config2_files[0][0], dtype=np.float32)
    alpha = np.random.default_rng(SEED + 21).normal(size=X.shape[0]).astype(np.float32)
    model = port.Model(port.Parameter(kernel_type="rbf", gamma=1.0 / X.shape[1]),
                       port.DataSet(X, np.asarray(labels).astype(int), dtype=np.float32),
                       alpha=alpha, rho=0.125)
    files = {how: os.path.join(tmp, f"parse-{how}.model") for how in ("native", "numpy")}
    loader.reset_counts()
    t0 = time.perf_counter()
    model.save(files["native"])
    t1 = time.perf_counter()
    read_native = model_file.parse_model_file(files["native"], dtype=np.float32)
    t2 = time.perf_counter()
    if (loader.native_parses, loader.native_writes) != (1, 1):
        raise AssertionError("parse: the model file did not go through the native library")
    with _numpy_io():
        t3 = time.perf_counter()
        model.save(files["numpy"])
        t4 = time.perf_counter()
        read_numpy = model_file.parse_model_file(files["native"], dtype=np.float32)
        t5 = time.perf_counter()
    contents = []
    for how in ("native", "numpy"):
        with open(files[how], "rb") as fh:
            contents.append(fh.read().split(b"\n", 1)[1])
    if contents[0] != contents[1]:
        raise AssertionError("parse: the native and NumPy model writers differ")
    for got, want in zip(read_native[1:4], read_numpy[1:4]):
        if not np.array_equal(np.asarray(got), np.asarray(want)):
            raise AssertionError("parse: the model file reads differently on the two paths")
    # the file groups the support vectors by class: the alphas in another order
    if read_native[4] != read_numpy[4] or not np.array_equal(np.sort(read_native[3]),
                                                              np.sort(alpha)):
        raise AssertionError("parse: the model file's labels or alphas did not round-trip")
    log("parse", f"model 10000 SVs x 200 ({len(contents[0]) / 1e6:.1f} MB): write native "
        f"{t1 - t0:.3f} s, NumPy {t4 - t3:.3f} s; read native {t2 - t1:.3f} s, NumPy "
        f"{t5 - t4:.3f} s; files byte for byte equal, arrays bit for bit")
    # before / after on this card: config 2's CLI runs of phase 4 with the
    # NumPy I/O (the parser before the native one), native, native, NumPy
    (train_file, _), (test_file, test_labels) = config2_files
    for run, how in enumerate(("NumPy", "native", "native", "NumPy")):
        with contextlib.ExitStack() as stack:
            if how == "NumPy":
                stack.enter_context(_numpy_io())
            fit_s, predict_s, predicted, io = _cli_fit_predict(
                f"parse-{run}", train_file, test_file, tmp,
                ["-t", "2", "-c", "1", "-e", str(EPSILON)])
        log("parse", f"config 2 CLI with {how} I/O (run {run + 1} of 4): fit {fit_s:.3f} s "
            f"(file I/O {io['fit_parse']:.3f} s, the rest {fit_s - io['fit_parse']:.3f} s), "
            f"predict {predict_s:.3f} s (file I/O {io['predict_parse']:.3f} s, the rest "
            f"{predict_s - io['predict_parse']:.3f} s), accuracy "
            f"{np.mean(predicted == test_labels):.4f}, native parses, writes {io['native']}")
        if io["native"] != ((3, 1) if how == "native" else (0, 0)):
            raise AssertionError(f"parse: the {how} CLI run's I/O went the other way")


class _Interrupted(Exception):
    """Raised by ``_interrupt_after`` to stop a checkpointed fit."""


@contextlib.contextmanager
def _interrupt_after(iteration):
    """A checkpointed fit stops, as if killed, right after it saved the CG
    state of ``iteration`` (or later)."""
    from plssvm_tpu_torch.solver import checkpoint

    save = checkpoint.save_checkpoint

    def save_then_stop(path, ckpt):
        save(path, ckpt)
        if ckpt.iteration >= iteration:
            raise _Interrupted(ckpt.iteration)

    checkpoint.save_checkpoint = save_then_stop
    try:
        yield
    finally:
        checkpoint.save_checkpoint = save


def _checkpoint_resume(label, make_svm, train, test, epsilon, tmp):
    """Fit uninterrupted; then fit with ``checkpoint_interval=5``, stopped
    after the save at iteration 10, and resume it from the file.  The
    resumed fit must take the uninterrupted fit's iterations and predict
    its labels; returns the logged facts."""
    import plssvm_tpu_torch as port

    path = os.path.join(tmp, f"extras-{label}.ckpt")
    plain = make_svm().fit(train, epsilon=epsilon)
    svm = make_svm()
    with _interrupt_after(10):
        try:
            svm.fit(train, epsilon=epsilon, checkpoint_path=path, checkpoint_interval=5)
            raise AssertionError(f"extras: the {label} fit ended before iteration 10")
        except _Interrupted as stop:
            stopped_at = stop.args[0]
    if not os.path.isfile(path):
        raise AssertionError(f"extras: {label} left no checkpoint")
    port.global_tracker.clear()
    t0 = time.perf_counter()
    resumed = svm.fit(train, epsilon=epsilon, checkpoint_path=path, checkpoint_interval=5)
    t1 = time.perf_counter()
    same = float(np.mean(svm.predict(resumed, test) == svm.predict(plain, test)))
    log("extras", f"checkpoint {label}: stopped after the save at iteration {stopped_at}, "
        f"resumed to {resumed.n_iter} iterations in {t1 - t0:.3f} s (uninterrupted "
        f"{plain.n_iter}), labels equal on {same:.4f}, max|d alpha| "
        f"{float(np.max(np.abs(np.asarray(resumed.alpha) - np.asarray(plain.alpha)))):.3e}, "
        f"file removed {not os.path.exists(path)}")
    if resumed.n_iter != plain.n_iter or same != 1.0 or os.path.exists(path):
        raise AssertionError(f"extras: the resumed {label} fit is not the uninterrupted one")


def phase_extras(tmp, config2_files, mc_files, ring_cells):
    """The solver extras on the card (float32 unless stated):

    - warm start: config 2 fitted to epsilon WARM_ROUGH_EPSILON, then
      warm-started from that model to 1e-8 beside a cold fit to 1e-8: label
      agreement >= 0.995, fewer iterations, and kernel A launched 2 +
      iterations + iterations // 50 times (the cold-start anchor costs one
      product);
    - class weights: the 10-class files through ``plssvm-torch-train
      --weight 3=2`` and ``plssvm-torch-predict``, as phase 5's run
      (accuracy floor, launches, no plain call, native I/O);
    - Jacobi: config 2 in float32 and float64 against the unpreconditioned
      fit, label agreement >= 0.995; then ROADMAP Queue 3's case, phase
      9's histogram classes in float32 to epsilon 1e-8 with Jacobi, logged
      per class (no gate: a finding);
    - checkpoint: config 2 in float64, and phase 8's laplacian files on
      the ring of four shards on cuda:0 in float64, stopped after the save
      at iteration 10 and resumed (``_checkpoint_resume``);
    - debug: a float32 fit with one NaN feature raises the located
      ``NumericCheckError`` with ``debug=True`` and stops at once without.
    """
    import plssvm_tpu_torch as port
    from plssvm_tpu_torch.ops import distance, gram_matmat, gram_matvec, matvec

    (train_file, _), (test_file, test_labels) = config2_files
    train = port.DataSet(train_file, dtype=np.float32)
    test = port.DataSet(test_file, dtype=np.float32)

    def rbf(dtype=np.float32, **kw):
        return port.CSVM(backend="cuda", device="cuda", dtype=dtype, kernel_type="rbf",
                         cost=1.0, solver="cg_implicit", **kw)

    # warm start
    svm = rbf()
    rough = svm.fit(train, epsilon=WARM_ROUGH_EPSILON)
    cold = svm.fit(train, epsilon=EPSILON)
    gram_matvec.reset_counts()
    port.global_tracker.clear()
    warm = svm.fit(train, epsilon=EPSILON, initial_model=rough)
    launches = gram_matvec.sym_tc_launches
    cg_s = _tracked("cg", "total_runtime") / 1000
    agree = float(np.mean(svm.predict(warm, test) == svm.predict(cold, test)))
    log("extras", f"warm start config 2: {WARM_ROUGH_EPSILON} fit {rough.n_iter} iterations; warm to "
        f"{EPSILON} {warm.n_iter} iterations in {cg_s:.3f} s against cold {cold.n_iter}; "
        f"label agreement {agree:.4f}; kernel A launches {launches}")
    if launches != 2 + warm.n_iter + warm.n_iter // 50 or gram_matvec.sym_launches:
        raise AssertionError(f"extras: the warm fit launched A {launches} times")
    if warm.n_iter >= cold.n_iter or agree < 0.995:
        raise AssertionError("extras: the warm fit is not shorter or not the cold one's")

    # class weights through the CLIs
    gram_matmat.reset_counts()
    train_mc, test_mc = mc_files["mc_train"][0], mc_files["mc_test"][0]
    fit_s, predict_s, predicted, io = _cli_fit_predict(
        "extras-weight", train_mc, test_mc, tmp,
        ["-t", "2", "-c", "1", "-e", str(EPSILON), "--weight", "3=2"])
    _check_cli_run("extras", f"{MC_CLASSES} classes --weight 3=2", fit_s, predict_s, io,
                   float(np.mean(predicted == mc_files["mc_test"][1])), MC_ACCURACY_FLOOR,
                   {"gram_matmat_sym_tc": gram_matmat.sym_tc_launches,
                    "gram_matmat_rect_tc": gram_matmat.rect_tc_launches},
                   matvec.sym_matmat_plain_calls + matvec.rect_matmat_plain_calls,
                   "gram_matmat_sym_tc", "gram_matmat_rect_tc")

    # Jacobi
    for dtype in (np.float32, np.float64):
        data = (train, test) if dtype == np.float32 else (
            port.DataSet(train_file, dtype=dtype), port.DataSet(test_file, dtype=dtype))
        plain_svm, jacobi_svm = rbf(dtype), rbf(dtype, preconditioner="jacobi")
        plain = plain_svm.fit(data[0], epsilon=EPSILON)
        port.global_tracker.clear()
        jacobi = jacobi_svm.fit(data[0], epsilon=EPSILON)
        cg_s = _tracked("cg", "total_runtime") / 1000
        predicted = jacobi_svm.predict(jacobi, data[1])
        agree = float(np.mean(predicted == plain_svm.predict(plain, data[1])))
        log("extras", f"jacobi config 2 {np.dtype(dtype).name}: {jacobi.n_iter} iterations "
            f"({cg_s / max(jacobi.n_iter, 1):.6f} s/iteration) against {plain.n_iter} "
            f"unpreconditioned, accuracy {np.mean(predicted == test_labels):.4f}, label "
            f"agreement {agree:.4f}")
        if agree < 0.995:
            raise AssertionError(f"extras: the Jacobi fit disagrees on {1 - agree} of labels")
    chi2 = ring_cells["chi2"]
    chi_train, chi_test = chi2["make"](np.float32)
    svm = port.CSVM(backend="cuda", device="cuda", dtype=np.float32, cost=1.0,
                    preconditioner="jacobi", solver="cg_implicit", **chi2["params"])
    port.global_tracker.clear()
    distance.reset_counts()
    t0 = time.perf_counter()
    model = svm.fit(chi_train, epsilon=1e-8, max_iter=JACOBI_CHI2_MAX_ITER)
    t1 = time.perf_counter()
    per_class = _tracked("cg", "iterations_per_class")
    reached = _tracked("cg", "residuum") <= _tracked("cg", "target_residuum")
    accuracy = float(np.mean(svm.predict(model, chi_test) == chi2["labels"]))
    log("extras", f"jacobi chi-squared {MC_CLASSES} histogram classes 10000x200 f32 to "
        f"epsilon 1e-8 (ROADMAP Queue 3's case; max_iter {JACOBI_CHI2_MAX_ITER}): "
        f"{model.n_iter} block iterations in {t1 - t0:.3f} s, per class {per_class}, "
        f"converged per class {[n < model.n_iter or reached for n in per_class]}, every "
        f"class reached epsilon {reached}, accuracy {accuracy:.4f}, kernel G launches "
        f"{distance.matmat_sym_launches}")

    # checkpoint and resume, float64: one device and the ring
    config2_64 = (port.DataSet(train_file, dtype=np.float64),
                  port.DataSet(test_file, dtype=np.float64))
    _checkpoint_resume("config 2 f64", lambda: rbf(np.float64), *config2_64, EPSILON, tmp)
    lap_train, lap_test = ring_cells["laplacian"]["make"](np.float64)
    _checkpoint_resume(
        f"laplacian f64, {RING_SHARDS} shards on cuda:0",
        lambda: port.CSVM(backend="cuda", devices=["cuda:0"] * RING_SHARDS,
                          dtype=np.float64, kernel_type="laplacian", cost=1.0,
                          solver="cg_implicit"),
        lap_train, lap_test, EPSILON, tmp)

    # debug
    X = np.asarray(train.data).copy()
    X[3, 1] = np.nan
    poisoned = port.DataSet(X, np.asarray(train.labels), dtype=np.float32)
    try:
        rbf(debug=True).fit(poisoned, epsilon=EPSILON)
        raise AssertionError("extras: debug=True did not catch the NaN feature")
    except port.NumericCheckError as err:
        message = str(err)
    quiet = rbf().fit(poisoned, epsilon=EPSILON)
    log("extras", f"debug: a NaN feature raised NumericCheckError('{message}'); without "
        f"debug the fit stopped after {quiet.n_iter} iterations, rho {quiet.rho}")
    if not message.startswith("initial CG residual |r0|^2 is non-finite") or quiet.n_iter:
        raise AssertionError("extras: the debug guard did not behave as plssvm_tpu's")


def phase_host_clis(tmp, config2_files):
    """``plssvm-torch-scale`` on config 2's training file (to [-1, 1], the
    factors saved) and ``plssvm-torch-generate-data`` at 10000 x 200,
    timed; both through the native parser and writer."""
    from plssvm_tpu_torch import DataSet
    from plssvm_tpu_torch.cli import generate_data, scale
    from plssvm_tpu_torch.native import loader

    train_file = config2_files[0][0]
    scaled, factors = os.path.join(tmp, "scaled.libsvm"), os.path.join(tmp, "factors.txt")
    loader.reset_counts()
    t0 = time.perf_counter()
    rc = scale.main(["-q", "-l", "-1", "-u", "1", "-s", factors, train_file, scaled])
    t1 = time.perf_counter()
    scale_io = (loader.native_parses, loader.native_writes)
    generated = os.path.join(tmp, "generated.libsvm")
    loader.reset_counts()
    t2 = time.perf_counter()
    rc_generate = generate_data.main(["-o", generated, "-n", "10000", "-d", "200",
                                      "--seed", str(SEED)])
    t3 = time.perf_counter()
    generate_io = (loader.native_parses, loader.native_writes)
    X = np.asarray(DataSet(scaled).data)
    shape = DataSet(generated).data.shape
    log("host-clis", f"plssvm-torch-scale config 2 train: {t1 - t0:.3f} s (native parses, "
        f"writes {scale_io}), scaled to [{X.min():.6f}, {X.max():.6f}]; "
        f"plssvm-torch-generate-data 10000x200: {t3 - t2:.3f} s (native parses, writes "
        f"{generate_io}), read back {shape}")
    if rc or rc_generate or scale_io != (1, 1) or generate_io != (0, 1) \
            or shape != (10000, 200) or X.min() < -1.0 or X.max() > 1.0:
        raise AssertionError("host-clis: scale or generate-data failed")


#: phase oao's gates: the label agreement of the batched and the sequential
#: one-vs-one fits (and of the machine-axis split against one device) in
#: float32, and in float64 at epsilon OAO_F64_EPSILON: the ring's gates
#: (PERF.md section 2)
OAO_AGREEMENT = 0.995
OAO_AGREEMENT_F64 = 0.999
OAO_F64_EPSILON = 1e-10
#: kernel O's checks against its plain version: machine counts, and the
#: longest machine of the ragged stacks (one machine has 2 rows)
PAIRS_CHECK_P = (3, 45)
PAIRS_CHECK_ROWS = 2000
#: phase oao's LS-SVR cell: Friedman #1 (Friedman, Ann. Statist. 19(1),
#: 1991; the formula of sklearn's make_friedman1), 10000 + 2000 rows, d =
#: 10, noise sigma 1; RBF at the default gamma 1/d, C = 10, epsilon 1e-6.
#: An exact float64 LS-SVR solve of 4000 rows of this set reads R^2 0.895
#: with numpy on a CPU; the Bayes-optimal R^2 is about 0.96
FRIEDMAN_N, FRIEDMAN_TEST, FRIEDMAN_D = 10000, 2000, 10
FRIEDMAN_EPSILON = 1e-6
FRIEDMAN_R2_FLOOR = 0.87
FRIEDMAN_R2_GAP = 0.005


def _pairs_bound(lens, d, kind, itemsize, tier=None):
    """The bound of kernel O's function on machines of ``lens`` rows: the
    sum_p l (l + 1) / 2 distinct pairs of the symmetric kernels (the FFMA
    walk evaluates each machine's upper triangle of tiles once, those pairs
    and half a diagonal tile's more; the tensor-core walks the full square,
    so they reach at most half of this), sum_p l^2 FFMAs of the
    contraction (one each way per pair), each machine's rows, norms,
    right-hand side and output moved once.  ``tier`` as in ``_sym_bound``: None the FFMA
    walk (float64 on the FP64 pipe), "tf32" / "bf16" the tensor-core walk
    (the rows at the tier's operand size, the rest float32), "dmma" the
    float64 tensor-core walk; on the tensor cores an RBF pair also takes
    one exp."""
    lens = np.asarray(lens, dtype=np.float64)
    cost = kind if kind in ("laplacian", "chi_squared") else "gram"
    pairs, rows = float(np.sum(lens * (lens + 1) / 2)), float(np.sum(lens))
    if tier in TC_TIERS:
        n_bytes = TC_TIERS[tier][1] * rows * d + 4 * rows * 3
    else:
        n_bytes = itemsize * rows * (d + 3)
    if tier is None and itemsize == 8:
        tier = "fp64"
    exp = tier in (*TC_TIERS, "dmma") and kind == "rbf"
    return _bound(pairs, d, float(np.sum(lens * lens)), cost, n_bytes, tier,
                  pairs if exp else 0)


def _pairs_stack(X, labels, dtype):
    """The batched one-vs-one solve's operands for ``X`` (n, d) and its
    ``labels``, on the card as ``_fit_oao_batched`` gathers them: the (P,
    m_pad, d) stack of each machine's dept rows, their squared norms and
    the machines' lengths."""
    classes = np.unique(labels)
    rows = [np.flatnonzero((labels == a) | (labels == b))[:-1]
            for i, a in enumerate(classes) for b in classes[i + 1:]]
    m_pad = max(len(r) for r in rows)
    idx = np.full((len(rows), m_pad), len(X), dtype=np.int64)
    for p, r in enumerate(rows):
        idx[p, :len(r)] = r
    X_aug = torch.zeros((len(X) + 1, X.shape[1]), dtype=dtype, device="cuda")
    X_aug[:len(X)] = torch.as_tensor(np.asarray(X), dtype=dtype, device="cuda")
    Xb = X_aug[torch.as_tensor(idx, device="cuda")]
    lens = torch.as_tensor([len(r) for r in rows], dtype=torch.int64, device="cuda")
    return Xb, (Xb * Xb).sum(-1), lens


def _pairs_rhs(Xb, lens, gen):
    """A seeded right-hand side, zero past each machine's rows."""
    mask = torch.arange(Xb.shape[1], device="cuda")[None, :] < lens[:, None]
    return torch.randn(Xb.shape[:2], generator=gen, dtype=Xb.dtype).cuda() * mask


def _pairs_tier(Xb, kind, precision):
    """(walk, bound tier) of kernel O on stack ``Xb`` at ``precision``."""
    from plssvm_tpu_torch.ops import pairs
    from plssvm_tpu_torch.parameter import KernelFunctionType as K

    route = pairs.walk(Xb, K.from_string(kind), precision)
    return route, {"tc": TIER_OF.get(precision), "dmma": "dmma"}.get(route)


def _pairs_plain(Xb, sq, V, lens, precision, **kw):
    """Kernel O's plain version on the tier's exact operands: the stack
    rounded to TF32 (its norms those of the float32 stack) for a float32
    Gram kind at "f32", as the tensor-core walk reads it; at "bf16" the
    plain version rounds to bf16 itself; else the stack as it is."""
    from plssvm_tpu_torch.ops import matvec, pairs

    if precision == "f32" and Xb.dtype == torch.float32 and sq is not None:
        Xb = matvec.round_to_tf32(Xb)
    return pairs.pairs_matvec_plain(Xb, sq, V, lens, precision=precision, **kw)


def _pairs_check(label, Xb, sq, V, lens, kind, gamma, coef0=0.0, precision="f32",
                 want=None):
    """Kernel O at ``precision`` against its plain version on the tier's
    operands (``_pairs_plain``; ``want`` when the caller has it) on one
    stack: max|err| / max|plain| within 1e-4 in float32 (the A / B card
    checks' tolerance at every tier: TF32 and bf16 against the plain
    version on the same rounded operands, "highest" and the distance kinds
    against full float32) or 1e-10 in float64, rows past each machine
    exactly 0, a second launch bit for bit the first.  Returns (max|err|,
    relative error, plain)."""
    from plssvm_tpu_torch.ops import pairs
    from plssvm_tpu_torch.parameter import KernelFunctionType as K

    kw = dict(kind=K.from_string(kind), gamma=gamma, coef0=coef0, degree=3)
    got = pairs.pairs_matvec(Xb, sq, V, lens, precision=precision, **kw)
    again = pairs.pairs_matvec(Xb, sq, V, lens, precision=precision, **kw)
    if want is None:
        want = _pairs_plain(Xb, sq, V, lens, precision, **kw)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    rel = err / float(want.abs().max())
    mask = torch.arange(Xb.shape[1], device="cuda")[None, :] < lens[:, None]
    tol = 1e-4 if Xb.dtype == torch.float32 else 1e-10
    if not (torch.isfinite(got).all() and rel <= tol and torch.equal(got, again)
            and bool((got[~mask] == 0).all())):
        raise AssertionError(f"kernel O {label}: max|err|/max|plain| {rel:.3e} (limit {tol}), "
                             f"repeat bit for bit {torch.equal(got, again)}")
    return err, rel, want


def _pairs_alone(label, Xb, sq, V, lens, kind, gamma, precision, machines):
    """Each of ``machines`` alone (a stack of one, m_pad its own length)
    against the same machine inside the stack: bit for bit, or raise."""
    from plssvm_tpu_torch.ops import pairs
    from plssvm_tpu_torch.parameter import KernelFunctionType as K

    kw = dict(kind=K.from_string(kind), gamma=gamma, coef0=0.0, degree=3,
              precision=precision)
    inside = pairs.pairs_matvec(Xb, sq, V, lens, **kw)
    for p in machines:
        n = int(lens[p])
        alone = pairs.pairs_matvec(
            Xb[p:p + 1, :n].contiguous(), None if sq is None else sq[p:p + 1, :n].contiguous(),
            V[p:p + 1, :n].contiguous(), lens[p:p + 1].clone(), **kw)[0]
        if not torch.equal(alone, inside[p, :n]):
            raise AssertionError(f"kernel O {label}: machine {p} ({n} rows) alone differs from "
                                 "itself inside the stack")


def _pairs_yardstick(Xb, lens, precision):
    """The Gram part alone of kernel O's function on cuBLAS: one
    ``torch.matmul(X_p, X_p.T)`` per machine at the tier (TF32 at "f32",
    bf16 operands at "bf16", full precision at "highest" and in float64),
    summed; median ms of 5 after 1 warm-up."""
    from plssvm_tpu_torch.solver.explicit import _tf32

    ops = [Xb[p, :n] for p, n in enumerate(lens.tolist()) if n]
    if precision == "bf16" and Xb.dtype == torch.float32:
        ops = [X.to(torch.bfloat16) for X in ops]

    def products():
        with _tf32(precision == "f32"):
            for X in ops:
                torch.matmul(X, X.T)

    return _median_ms(products, 5, 1)


def _pairs_time(label, Xb, sq, V, lens, kind, gamma, coef0=0.0, precision="f32"):
    """Kernel O's and its plain version's ms at one stack and tier
    (``_time_pair``'s order plain, O, O, plain; O on the operand copy a
    solve makes once, whose own ms is logged), beside the bound and, for
    the Gram kinds, the per-machine cuBLAS yardstick.  Returns (ms, plain
    ms, bound, yardstick ms or None)."""
    from plssvm_tpu_torch.ops import pairs
    from plssvm_tpu_torch.parameter import KernelFunctionType as K

    kind_t = K.from_string(kind)
    route, tier = _pairs_tier(Xb, kind, precision)
    kw = dict(kind=kind_t, gamma=gamma, coef0=coef0, degree=3, precision=precision)
    # the Gram kinds' readings name the tier, the distance kinds' (no tier)
    # the type
    tag = precision if sq is not None else ("f32" if Xb.dtype == torch.float32 else "f64")
    copy_ms = _median_ms(lambda: pairs.pairs_operand(Xb, kind_t, precision), 5, 1)
    operand = pairs.pairs_operand(Xb, kind_t, precision)
    lens_h = lens.cpu().numpy().astype(np.float64)
    # the pairs as walked: the FFMA walk's triangle, the tensor-core walks'
    # full square
    if route == "ffma":
        walked, counted = lens_h * (lens_h + 1) / 2, "sum_p len_p (len_p + 1) / 2 d, the triangle"
    else:
        walked, counted = lens_h ** 2, "sum_p len_p^2 d, the full square"
    k_ms, p_ms = _time_pair(
        f"pairs_matvec ({route})",
        lambda *a, **k: pairs.pairs_matvec(*a, operand=operand, **k),
        pairs.pairs_matvec_plain, (Xb, sq, V, lens), kw, float(np.sum(walked)) * Xb.shape[2],
        f"{tag} {label}", plain_repeats=3, unit="T pair-features/s",
        counted=f"{counted}, as walked")
    bound = _pairs_bound(lens_h, Xb.shape[2], kind, Xb.element_size(), tier)
    _log_bound(f"pairs_matvec ({route})", f"{tag} {label}", k_ms, bound)
    yard = None if sq is None else _pairs_yardstick(Xb, lens, precision)
    log("oao", f"kernel O ({route}) {tag} {label}: operand copy "
        + (f"{copy_ms:.3f} ms once per solve" if operand is not None else "none")
        + ("" if yard is None else f"; yardstick {yard:.3f} ms (per-machine torch.matmul "
           f"(X_p, X_p.T) at the tier, summed: the Gram part only)"))
    return k_ms, p_ms, bound, yard


def _pairs_per_entry(label, X, gamma):
    """Kernel O's chi-squared entries on one machine's rows ``X``, picked by
    one-hot right-hand sides (``entry_errors``), in float32 against the
    plain version in float64 and in float64 against long double, beside the
    plain version's own worst error in the type; the card test's gates:
    float32 within min(4x plain, 1e-4) (the approximate reciprocal, ROADMAP
    Queue 3 item 3), float64 within 2x plain (the divide-free quotient)."""
    from plssvm_tpu_torch.ops import pairs
    from plssvm_tpu_torch.ops.entry_check import entry_errors

    m = X.shape[0]
    columns = [int(j) for j in np.linspace(0, m - 1, MC_CLASSES)]
    lens = torch.tensor([m], dtype=torch.int64, device="cuda")

    def one_machine(Xm, v, kind, gamma):
        return pairs.pairs_matvec(Xm[None], None, v[None], lens, kind=kind, gamma=gamma,
                                  coef0=0.0, degree=3)[0]

    for dtype in (torch.float32, torch.float64):
        got, plain = entry_errors(one_machine, X.to(dtype).contiguous(), columns, gamma,
                                  one_column=True)
        limit = min(4 * plain, 1e-4) if dtype == torch.float32 else 2 * plain
        log("oao", f"kernel O chi-squared per entry {label} {dtype}: worst relative error "
            f"{got:.3e}, plain version {plain:.3e} ({got / plain:.2f}x, limit {limit:.3e})")
        if not got <= limit:
            raise AssertionError(f"kernel O chi-squared {dtype} per entry: {got} past {limit}")


def _friedman1(rng, n):
    """Friedman #1: 10 sin(pi x0 x1) + 20 (x2 - 0.5)^2 + 10 x3 + 5 x4 + N(0,
    1), x uniform on [0, 1]^FRIEDMAN_D."""
    X = rng.uniform(size=(n, FRIEDMAN_D))
    y = (10.0 * np.sin(np.pi * X[:, 0] * X[:, 1]) + 20.0 * (X[:, 2] - 0.5) ** 2
         + 10.0 * X[:, 3] + 5.0 * X[:, 4] + rng.normal(size=n))
    return X, y


def _oao_fit(label, svm, train, test, labels, epsilon, phase="oao"):
    """A one-vs-one fit of ``train`` and the predict of ``test``, with
    kernels O and D counted from 0 (and A-C, N): returns the log fields."""
    import plssvm_tpu_torch as port
    from plssvm_tpu_torch.ops import distance, gram_matmat, gram_matvec, kernel_matrix, pairs

    for module in (pairs, gram_matvec, gram_matmat, distance, kernel_matrix):
        module.reset_counts()
    port.global_tracker.clear()
    t0 = time.perf_counter()
    model = svm.fit(train, classification="oao", epsilon=epsilon)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    strategy = _tracked("cg", "oao_strategy")
    block = _tracked("cg", "block_iterations") if strategy == "batched" else None
    cg_s = _tracked("cg", "total_runtime") / 1000
    per_machine = model.n_iter_per_machine
    counts = dict(pairs=pairs.launches + pairs.tc_launches + pairs.dmma_launches,
                  ffma=pairs.launches, tc=pairs.tc_launches, dmma=pairs.dmma_launches,
                  plain=pairs.plain_calls,
                  A=gram_matvec.sym_tc_launches + gram_matvec.sym_dmma_launches
                  + gram_matvec.sym_launches,
                  E=distance.matvec_sym_launches,
                  N=kernel_matrix.sym_launches)
    predicted = svm.predict(model, test)
    t2 = time.perf_counter()
    counts["D"] = (gram_matmat.rect_tc_launches + gram_matmat.rect_dmma_launches
                   + gram_matmat.rect_launches)
    counts["H"] = distance.matmat_rect_launches
    accuracy = float(np.mean(predicted == labels))
    finite = bool(np.all(np.isfinite(model.alpha)) and np.all(np.isfinite(model.rho)))
    log(phase, f"{label}: strategy {strategy}, iterations per machine {per_machine} (sum "
        f"{model.n_iter}" + (f", {block} block iterations, {cg_s / max(block, 1):.6f} "
                             "s/iteration" if block is not None else
                             f", {cg_s / max(model.n_iter, 1):.6f} s per machine iteration")
        + f"), fit {t1 - t0:.3f} s, predict {t2 - t1:.3f} s, accuracy {accuracy:.4f}, "
        f"launches {counts}")
    if not finite:
        raise AssertionError(f"{phase} {label}: non-finite model")
    return dict(model=model, predicted=predicted, accuracy=accuracy, strategy=strategy,
                block=block, fit_s=t1 - t0, counts=counts, per_machine=per_machine)


def _agreement(phase, label, a, b, floor):
    agree = float(np.mean(a["predicted"] == b["predicted"]))
    log(phase, f"{label}: label agreement {agree:.4f} (gate {floor})")
    if agree < floor:
        raise AssertionError(f"{phase} {label}: labels agree on {agree} < {floor}")
    return agree


def _check_batched_launches(phase, label, run, walk, groups=1):
    """A batched fit launched kernel O once for the initial residual, once
    per block iteration and once more every 50th, all on the walk ``walk``
    ("tc", "dmma" or "ffma"), and no plain version; its predict went
    through kernel D or H.  With its machines split over ``groups``
    devices each group runs its own loop: the count is the sum over the
    groups (``machine_groups``' contiguous ranges), each group's block
    iterations its slowest machine's."""
    from plssvm_tpu_torch.parallel.sharded import machine_groups

    c = run["counts"]
    per_machine = list(run["per_machine"])
    blocks = [max(per_machine[lo:hi]) for lo, hi in machine_groups(len(per_machine), groups)]
    if groups == 1:
        blocks = [run["block"]]
    want = sum(1 + b + b // 50 for b in blocks)
    if run["strategy"] != "batched" or c["pairs"] != want or c[walk] != want \
            or c["plain"] != 0 or c["D"] + c["H"] <= 0:
        raise AssertionError(f"{phase} {label}: strategy {run['strategy']}, O launched "
                             f"{c['pairs']} times ({c[walk]} on its {walk} walk) for block "
                             f"iterations {blocks} "
                             f"(want {want}), plain calls {c['plain']}, predict launches "
                             f"D {c['D']} H {c['H']}")


def _pairs_blocks_per_sm():
    """Blocks per SM of kernel O's tensor-core walks (RBF): two for TF32
    and bf16, one for float64, as designed; raise below."""
    import ctypes

    from plssvm_tpu_torch.ops import _build

    lib = _build.load()
    blocks = {}
    for walk, name, least in ((0, "tf32", 2), (1, "bf16", 2), (2, "f64", 1)):
        n = ctypes.c_int(0)
        err = lib.plssvm_pairs_blocks_per_sm(walk, 2, ctypes.byref(n))
        if err != 0 or n.value < least:
            raise AssertionError(f"kernel O's {name} walk: {n.value} blocks an SM (error {err})")
        blocks[name] = n.value
    log("oao", f"kernel O's tensor-core walks, blocks per SM: {blocks}")


def phase_oao(tmp, mc_written, chi2_cell, mnist_cell, main_ms):
    """One-vs-one training and LS-SVR (ROADMAP Queue 1 item 6, item 7's
    LS-SVR):

    (a) kernel O against its plain version, every kind at every tier
        ("f32", "bf16", "highest") in float32 and float64, on ragged stacks
        of 3 and 45 machines (one of 2 rows, the others up to
        PAIRS_CHECK_ROWS), twice on the same input (bit for bit), the worst
        relative error per kind, type and walk logged; the 2-row and the
        longest machine alone against themselves inside the 45-machine
        stack, bit for bit, at every tier in both types;
    (b) phase 5's 10 Gaussian classes (RBF) through ``plssvm-torch-train
        --classification oao`` and ``plssvm-torch-predict``: ``automatic``
        batched, O's launches on the TF32 walk, the accuracy floor; the
        sequential strategy beside it (agreement >= 0.995), batched fits at
        "bf16" (logged) and "highest" (>= 0.995 against sequential), and
        both strategies in float64 at epsilon 1e-10 (>= 0.999); O checked
        and timed at this stack at every tier and in float64 (beside the
        FFMA walk in float64), the TF32 walk against full float32 within
        TF32's first-order bound;
    (c) phase 9's histogram classes (chi-squared): batched on O, sequential
        on kernel N through ``automatic``'s ``cg_explicit``; floor 0.84,
        agreement >= 0.995; O checked and timed there, and held per entry
        of K on one machine's rows in float32 and float64;
    (d) phase 7's MNIST-width classes (60000 x 784): ``automatic`` batched
        (1.69 GB <= 2 GiB), fit seconds, iterations and s/iteration, O
        checked and timed at every tier beside its bound and the cuBLAS
        yardstick at this stack (its TF32 time recorded for the cost
        ranking), the floor; a sequential fit beside it for its seconds;
    (e) the machine axis: (b)'s fit with ``devices=["cuda:0"] * 4`` against
        one device in float32 and float64 (epsilon 1e-10), each
        bit-identical with the same iterations per machine, or raise:
        agreement, max|d alpha|, max|d rho|;
    (f) LS-SVR on Friedman #1 through ``plssvm-torch-train -s epsilon_svr``
        and ``plssvm-torch-predict`` in float32 and float64: R^2 >= 0.87,
        the two within 0.005, the predict file's values those the CLI
        computed in memory.

    Returns (launches, (main_err, timing, bounds) entries for kernel O)."""
    import plssvm_tpu_torch as port
    from plssvm_tpu_torch.csvm import CSVM
    from plssvm_tpu_torch.ops import gram_matvec, matvec, pairs
    from plssvm_tpu_torch.parameter import KernelFunctionType as K

    gen = torch.Generator().manual_seed(SEED + 40)
    rng = np.random.default_rng(SEED + 40)
    kinds = (("polynomial", 1.0), ("rbf", 0.0), ("sigmoid", -0.5), ("laplacian", 0.0),
             ("chi_squared", 0.0))
    tiers = ("f32", "bf16", "highest")
    _pairs_blocks_per_sm()
    # (a) ragged stacks
    worst = {}
    for P in PAIRS_CHECK_P:
        lens_h = rng.integers(PAIRS_CHECK_ROWS // 2, PAIRS_CHECK_ROWS + 1, P)
        lens_h[P // 2] = 2
        m_pad, d = int(lens_h.max()), 200
        for dtype in (torch.float32, torch.float64):
            mask = torch.arange(m_pad)[None, :] < torch.as_tensor(lens_h)[:, None]
            X_pos = torch.rand((P, m_pad, d), generator=gen, dtype=dtype) * mask[..., None]
            lens = torch.as_tensor(lens_h, dtype=torch.int64, device="cuda")
            V = (torch.randn((P, m_pad), generator=gen, dtype=dtype) * mask).cuda()
            type_name = "f32" if dtype == torch.float32 else "f64"
            for kind, coef0 in kinds:
                Xb = X_pos if kind == "chi_squared" else (X_pos - 0.5 * mask[..., None]) * 0.3
                Xb = Xb.cuda()
                sq = None if kind in ("laplacian", "chi_squared") else (Xb * Xb).sum(-1)
                # the plain version depends on the tier for the float32 Gram
                # kinds only
                tiered = dtype == torch.float32 and sq is not None
                plain = {}
                for precision in tiers:
                    route, _ = _pairs_tier(Xb, kind, precision)
                    key = precision if tiered else None
                    _, rel, plain[key] = _pairs_check(
                        f"{kind} {type_name} {precision} P={P}", Xb, sq, V, lens, kind, 1.0 / d,
                        coef0, precision, plain.get(key))
                    walked = (kind, type_name, precision if route == "tc" else route)
                    worst[walked] = max(worst.get(walked, 0.0), rel)
                    if P == max(PAIRS_CHECK_P) and kind in ("rbf", "chi_squared"):
                        _pairs_alone(f"{kind} {type_name} {precision}", Xb, sq, V, lens, kind,
                                     1.0 / d, precision, (P // 2, int(np.argmax(lens_h))))
    log("oao", "kernel O against plain, worst max|err|/max|plain| over P in "
        f"{PAIRS_CHECK_P} (ragged, one machine of 2 rows, d = 200), bit for bit on a "
        "second launch, the 2-row and the longest machine alone bit for bit their rows "
        "inside the 45-machine stack (rbf, chi_squared): "
        + ", ".join(f"{k} {t} {w} {v:.3e}" for (k, t, w), v in worst.items()))

    # (b) the 10 Gaussian classes at config 2's shape
    train_file, test_file = mc_written["mc_train"][0], mc_written["mc_test"][0]
    labels = mc_written["mc_test"][1]
    train = port.DataSet(train_file, dtype=np.float32)
    gamma = 1.0 / 200
    tables = ({}, {}, {})
    tiers_b = {}
    for dtype in (torch.float32, torch.float64):
        Xb, sq, lens = _pairs_stack(np.asarray(train.data), np.asarray(train.labels), dtype)
        V = _pairs_rhs(Xb, lens, gen)
        label = f"at (b)'s stack {tuple(Xb.shape)}"
        for precision in (tiers if dtype == torch.float32 else ("f32",)):
            err, _, _ = _pairs_check(f"rbf {label}", Xb, sq, V, lens, "rbf", gamma,
                                     precision=precision)
            tiers_b[(dtype, precision)] = (err, *_pairs_time(label, Xb, sq, V, lens, "rbf",
                                                            gamma, precision=precision))
        if dtype == torch.float32:
            _check_tf32_tier(
                f"kernel O rbf {label}", pairs.pairs_matvec(Xb, sq, V, lens, kind=K.RBF,
                                                            gamma=gamma, coef0=0.0, degree=3),
                pairs.pairs_matvec_plain(Xb, sq, V, lens, kind=K.RBF, gamma=gamma, coef0=0.0,
                                         degree=3, precision="highest"),
                gamma, float(sq.max()))
        else:
            # the float64 Gram walk that the DMMA walk replaced, timed beside it
            kw = dict(kind=K.RBF, gamma=gamma, coef0=0.0, degree=3)
            dmma_ms = tiers_b[(dtype, "f32")][1]
            ffma_ms = _median_ms(lambda: pairs.ffma_pairs_matvec(Xb, sq, V, lens, **kw))
            err_ffma = float((pairs.ffma_pairs_matvec(Xb, sq, V, lens, **kw)
                              - pairs.pairs_matvec(Xb, sq, V, lens, **kw)).abs().max())
            log("oao", f"kernel O f64 rbf {label}: DMMA walk {dmma_ms:.3f} ms, the FFMA walk "
                f"{ffma_ms:.3f} ms ({ffma_ms / dmma_ms:.2f}x), max|DMMA - FFMA| "
                f"{err_ffma:.3e}")
        del Xb, sq, V
    for key, (dtype, precision) in ((("pairs_matvec_tc", "bf16"), (torch.float32, "bf16")),
                                    (("pairs_matvec", "rbf"), (torch.float32, "highest")),
                                    (("pairs_matvec_dmma", "f64"), (torch.float64, "f32"))):
        err, ms, plain_ms, bound, _ = tiers_b[(dtype, precision)]
        for table, value in zip(tables, (err, (ms, plain_ms), bound)):
            table[key] = value
    main_ms[("pairs_matvec", "oao")] = (tiers_b[(torch.float32, "highest")][1],
                                        tiers_b[(torch.float32, "highest")][3][0])
    main_ms[("pairs_matvec_dmma", "oao")] = (tiers_b[(torch.float64, "f32")][1],
                                             tiers_b[(torch.float64, "f32")][3][0])
    main_ms[(("pairs_matvec_tc", "bf16"), "oao")] = (tiers_b[(torch.float32, "bf16")][1],
                                                     tiers_b[(torch.float32, "bf16")][3][0])
    pairs.reset_counts()
    port.global_tracker.clear()
    fit_s, predict_s, predicted, io = _cli_fit_predict(
        "oao", train_file, test_file, tmp,
        ["--classification", "oao", "-t", "2", "-c", "1", "-e", str(EPSILON)],
        solver="automatic")
    strategy = _tracked("cg", "oao_strategy")
    block = _tracked("cg", "block_iterations")
    per_machine = _tracked("cg", "iterations_per_machine")
    cg_s = _tracked("cg", "total_runtime") / 1000
    launches_b = pairs.tc_launches
    accuracy = float(np.mean(predicted == labels))
    log("oao", f"{MC_CLASSES} classes rbf f32 (CLI, --classification oao): strategy "
        f"{strategy}, {block} block iterations, iterations per machine {per_machine}, "
        f"{cg_s / block:.6f} s/iteration, CG {cg_s:.3f} s, fit (CLI) {fit_s:.3f} s, predict "
        f"(CLI) {predict_s:.3f} s, accuracy {accuracy:.4f}, kernel O launches (TF32 walk) "
        f"{launches_b}, FFMA walk {pairs.launches}, plain calls {pairs.plain_calls}; native "
        f"parses, writes {io['native']}")
    if strategy != "batched" or launches_b != 1 + block + block // 50 or pairs.plain_calls \
            or pairs.launches:
        raise AssertionError(f"oao: the CLI fit took {strategy}, O's TF32 walk launched "
                             f"{launches_b} times for {block} block iterations")
    if accuracy < MC_ACCURACY_FLOOR:
        raise AssertionError(f"oao: accuracy {accuracy} below {MC_ACCURACY_FLOOR}")
    test = port.DataSet(test_file, dtype=np.float32)
    runs = {}
    for strat, precision in (("batched", "f32"), ("sequential", "f32"), ("bf16", "bf16"),
                             ("highest", "highest")):
        svm = CSVM(backend="cuda", device="cuda", dtype=np.float32, kernel_type="rbf",
                   cost=1.0, oao_batch="batched" if strat != "sequential" else strat,
                   gram_precision=precision)
        runs[strat] = _oao_fit(f"{MC_CLASSES} classes rbf f32 {strat} ({precision})", svm,
                               train, test, labels, EPSILON)
    _check_batched_launches("oao", "(b) f32 batched", runs["batched"], "tc")
    _check_batched_launches("oao", "(b) f32 batched at bf16", runs["bf16"], "tc")
    _check_batched_launches("oao", "(b) f32 batched at highest", runs["highest"], "ffma")
    if runs["sequential"]["counts"]["A"] <= 0 or runs["sequential"]["counts"]["pairs"]:
        raise AssertionError("oao: the sequential fit did not take kernel A only")
    _agreement("oao", "(b) f32 batched vs sequential", runs["batched"], runs["sequential"],
               OAO_AGREEMENT)
    _agreement("oao", "(b) f32 batched (CSVM) vs the CLI's", runs["batched"],
               dict(predicted=predicted), OAO_AGREEMENT)
    _agreement("oao", "(b) f32 batched at highest vs sequential", runs["highest"],
               runs["sequential"], OAO_AGREEMENT)
    _agreement("oao", "(b) f32 batched at bf16 vs sequential (logged, no gate)", runs["bf16"],
               runs["sequential"], 0.0)
    train64 = port.DataSet(train_file, dtype=np.float64)
    test64 = port.DataSet(test_file, dtype=np.float64)
    runs64 = {}
    for strat in ("batched", "sequential"):
        svm = CSVM(backend="cuda", device="cuda", dtype=np.float64, kernel_type="rbf",
                   cost=1.0, oao_batch=strat)
        runs64[strat] = _oao_fit(f"{MC_CLASSES} classes rbf f64 {strat} epsilon "
                                 f"{OAO_F64_EPSILON}", svm, train64, test64, labels,
                                 OAO_F64_EPSILON)
    _check_batched_launches("oao", "(b) f64 batched", runs64["batched"], "dmma")
    _agreement("oao", "(b) f64 batched vs sequential", runs64["batched"],
               runs64["sequential"], OAO_AGREEMENT_F64)

    # (c) the histogram classes, chi-squared
    gamma_c = chi2_cell["params"]["gamma"]
    train_c, test_c = chi2_cell["make"](np.float32)
    Xb, sq, lens = _pairs_stack(np.asarray(train_c.data), np.asarray(train_c.labels),
                                torch.float32)
    V = _pairs_rhs(Xb, lens, gen)
    err_c, _, _ = _pairs_check("chi_squared at (c)'s stack", Xb, None, V, lens, "chi_squared",
                               gamma_c)
    _pairs_per_entry("at (c)'s first machine", Xb[0, :int(lens[0])], gamma_c)
    ms_c, plain_c, bound_c, _ = _pairs_time(f"chi_squared at (c)'s stack {tuple(Xb.shape)}",
                                            Xb, None, V, lens, "chi_squared", gamma_c)
    for table, value in zip(tables, (err_c, (ms_c, plain_c), bound_c)):
        table[("pairs_matvec", "chi_squared")] = value
    main_ms[(("pairs_matvec", "chi_squared"), "oao")] = (ms_c, bound_c[0])
    # the FFMA walk's other kinds and types at (c)'s stack (no main-path fit
    # here runs them): laplacian in float32, chi-squared and laplacian in
    # float64, each checked and timed beside its bound and plain version
    ffma_c = {("f32", "chi_squared"): (ms_c, plain_c, bound_c)}
    for dtype, kind, g in ((torch.float32, "laplacian", 1.0 / Xb.shape[2]),
                           (torch.float64, "chi_squared", gamma_c),
                           (torch.float64, "laplacian", 1.0 / Xb.shape[2])):
        type_name = "f32" if dtype == torch.float32 else "f64"
        Xk, Vk = Xb.to(dtype), V.to(dtype)
        label = f"{kind} at (c)'s stack {tuple(Xb.shape)}"
        _pairs_check(f"{kind} {type_name} at (c)'s stack", Xk, None, Vk, lens, kind, g)
        ffma_c[(type_name, kind)] = _pairs_time(label, Xk, None, Vk, lens, kind, g)[:3]
        del Xk, Vk
    log("oao", "(c) kernel O's FFMA walk at (c)'s stack: " + ", ".join(
        f"{k} {t} {ms:.3f} ms (plain {p_ms:.3f}, bound {b[0]:.3f} {b[1]}, share "
        f"{b[0] / ms:.3f})" for (t, k), (ms, p_ms, b) in ffma_c.items()))
    del Xb, sq, V
    runs_c = {}
    for strat in ("batched", "sequential"):
        svm = CSVM(backend="cuda", device="cuda", dtype=np.float32, kernel_type="chi_squared",
                   gamma=gamma_c, cost=1.0, oao_batch=strat)
        runs_c[strat] = _oao_fit(f"{MC_CLASSES} histogram classes chi-squared f32 {strat}",
                                 svm, train_c, test_c, chi2_cell["labels"], CHI2_EPSILON)
    _check_batched_launches("oao", "(c) batched", runs_c["batched"], "ffma")
    if runs_c["sequential"]["counts"]["N"] != len(runs_c["sequential"]["per_machine"]) \
            or runs_c["sequential"]["counts"]["pairs"]:
        raise AssertionError("oao: the sequential chi-squared machines did not each build K "
                             "with kernel N")
    for strat, run in runs_c.items():
        if run["accuracy"] < CHI2_ACCURACY_FLOOR:
            raise AssertionError(f"oao (c) {strat}: accuracy {run['accuracy']} below "
                                 f"{CHI2_ACCURACY_FLOOR}")
    _agreement("oao", "(c) batched vs sequential", runs_c["batched"], runs_c["sequential"],
               OAO_AGREEMENT)
    launches_c = runs_c["batched"]["counts"]["ffma"]
    del train_c, test_c

    # (d) MNIST width
    train_d, test_d = mnist_cell["make"](np.float32)
    svm = CSVM(backend="cuda", device="cuda", dtype=np.float32, kernel_type="rbf", cost=1.0)
    dmax = max(int(np.sum(np.isin(np.asarray(train_d.labels), pair))) - 1
               for pair in [(a, b) for a in range(MC_CLASSES) for b in range(a + 1, MC_CLASSES)])
    stack = 45 * dmax * 784 * 4
    log("oao", f"(d) MNIST width: the batched stack is 45 x {dmax} x 784 float32 = {stack} "
        f"bytes against the {svm._oao_batch_budget()}-byte budget")
    Xb, sq, lens = _pairs_stack(np.asarray(train_d.data), np.asarray(train_d.labels),
                                torch.float32)
    V = _pairs_rhs(Xb, lens, gen)
    label = f"at (d)'s stack {tuple(Xb.shape)}"
    tiers_d = {}
    for precision in tiers:
        err, _, _ = _pairs_check(f"rbf {label}", Xb, sq, V, lens, "rbf", 1.0 / 784,
                                 precision=precision)
        tiers_d[precision] = (err, *_pairs_time(label, Xb, sq, V, lens, "rbf", 1.0 / 784,
                                                precision=precision))
    err, ms, plain_ms, bound, _ = tiers_d["f32"]
    for table, value in zip(tables, (err, (ms, plain_ms), bound)):
        table[("pairs_matvec_tc", "tf32")] = value
    main_ms[("pairs_matvec_tc", "oao")] = (ms, bound[0])
    log("oao", "(d) kernel O at " + ", ".join(
        f"{p} {tiers_d[p][1]:.3f} ms (bound {tiers_d[p][3][0]:.3f}, yardstick "
        f"{tiers_d[p][4]:.3f})" for p in tiers) + f"; plain at f32 {plain_ms:.3f} ms")
    if not ms < plain_ms:
        raise AssertionError(f"oao (d): O's TF32 walk {ms:.3f} ms is not faster than the "
                             f"plain per-machine walk's {plain_ms:.3f} ms")
    del Xb, sq, V
    torch.cuda.empty_cache()
    run_d = _oao_fit("(d) rbf 60000x784 f32 automatic", svm, train_d, test_d,
                     mnist_cell["labels"], EPSILON)
    _check_batched_launches("oao", "(d)", run_d, "tc")
    launches_d = run_d["counts"]["tc"]
    if run_d["accuracy"] < MC_ACCURACY_FLOOR:
        raise AssertionError(f"oao (d): accuracy {run_d['accuracy']} below {MC_ACCURACY_FLOOR}")
    seq = CSVM(backend="cuda", device="cuda", dtype=np.float32, kernel_type="rbf", cost=1.0,
               oao_batch="sequential")
    run_ds = _oao_fit("(d) rbf 60000x784 f32 sequential", seq, train_d, test_d,
                      mnist_cell["labels"], EPSILON)
    log("oao", f"(d) fit seconds: batched {run_d['fit_s']:.3f}, sequential "
        f"{run_ds['fit_s']:.3f}; label agreement "
        f"{float(np.mean(run_d['predicted'] == run_ds['predicted'])):.4f}")
    del train_d, test_d

    # (e) the machine axis on (b)'s data
    for dtype, data, one, epsilon, floor in (
            (np.float32, (train, test), runs["batched"], EPSILON, OAO_AGREEMENT),
            (np.float64, (train64, test64), runs64["batched"], OAO_F64_EPSILON,
             OAO_AGREEMENT_F64)):
        svm = CSVM(backend="cuda", devices=["cuda:0"] * 4, dtype=dtype, kernel_type="rbf",
                   cost=1.0, oao_batch="batched")
        name = np.dtype(dtype).name
        split = _oao_fit(f"(e) {name} machines split over 4 x cuda:0", svm, *data, labels,
                         epsilon)
        _check_batched_launches("oao", f"(e) {name}", split,
                                "tc" if dtype == np.float32 else "dmma", groups=4)
        d_alpha = float(np.max(np.abs(np.asarray(split["model"].alpha, dtype=np.float64)
                                      - np.asarray(one["model"].alpha, dtype=np.float64))))
        d_rho = float(np.max(np.abs(split["model"].rho - one["model"].rho)))
        identical = bool(np.array_equal(split["model"].alpha, one["model"].alpha)
                         and np.array_equal(split["model"].rho, one["model"].rho))
        log("oao", f"(e) {name} split against one device: max|d alpha| {d_alpha:.3e}, "
            f"max|d rho| {d_rho:.3e}, bit-identical {identical}, iterations per machine "
            f"equal {split['per_machine'] == one['per_machine']}")
        _agreement("oao", f"(e) {name} split vs one device", split, one, floor)
        if not identical or split["per_machine"] != one["per_machine"]:
            raise AssertionError(f"oao (e): the {name} split is not bit-identical to one "
                                 "device (kernel O gives each machine its own sums, and the "
                                 "CG scalars fold along each machine's rows)")

    # (f) LS-SVR on Friedman #1
    frng = np.random.default_rng(SEED + 41)
    X, y = _friedman1(frng, FRIEDMAN_N + FRIEDMAN_TEST)
    svr_train = os.path.join(tmp, "friedman_train.libsvm")
    svr_test = os.path.join(tmp, "friedman_test.libsvm")
    port.DataSet(X[:FRIEDMAN_N], y[:FRIEDMAN_N], regression=True).save(svr_train)
    port.DataSet(X[FRIEDMAN_N:], y[FRIEDMAN_N:], regression=True).save(svr_test)
    targets = np.asarray(port.DataSet(svr_test, regression=True).labels)
    r2 = {}
    for name, extra in (("float32", []), ("float64", ["--use_double_as_real_type"])):
        recorded = []
        predict = CSVM.predict

        def recording(self, model, data):
            values = predict(self, model, data)
            recorded.append(values)
            return values

        gram_matvec.reset_counts()
        CSVM.predict = recording
        try:
            fit_s, predict_s, values, _ = _cli_fit_predict(
                f"svr-{name}", svr_train, svr_test, tmp,
                ["-s", "epsilon_svr", "-t", "2", "-c", "10", "-e", str(FRIEDMAN_EPSILON)]
                + extra, solver="automatic", parse=float, predict_flags=extra)
        finally:
            CSVM.predict = predict
        iterations = _tracked("cg", "iterations")
        cg_s = _tracked("cg", "total_runtime") / 1000
        written = np.asarray([float(format(v, ".10g")) for v in recorded[0]])
        r2[name] = 1.0 - np.sum((targets - values) ** 2) / np.sum(
            (targets - targets.mean()) ** 2)
        a = (gram_matvec.sym_tc_launches if name == "float32"
             else gram_matvec.sym_dmma_launches)
        b = (gram_matvec.rect_tc_launches if name == "float32"
             else gram_matvec.rect_dmma_launches)
        log("oao", f"(f) LS-SVR Friedman #1 {FRIEDMAN_N}x{FRIEDMAN_D} {name} (CLI -s "
            f"epsilon_svr): {iterations} CG iterations, {cg_s / max(iterations, 1):.6f} "
            f"s/iteration, fit (CLI) {fit_s:.3f} s, predict (CLI) {predict_s:.3f} s, R^2 "
            f"{r2[name]:.4f}, kernel A / B launches ({a}, {b})")
        if not np.array_equal(values, written):
            raise AssertionError(f"oao (f) {name}: the predict file's values are not those "
                                 "computed in memory")
        if a != 1 + iterations + iterations // 50 or b <= 0:
            raise AssertionError(f"oao (f) {name}: LS-SVR did not go through kernels A and B")
        if not r2[name] >= FRIEDMAN_R2_FLOOR:
            raise AssertionError(f"oao (f) {name}: R^2 {r2[name]} below {FRIEDMAN_R2_FLOOR}")
    if abs(r2["float32"] - r2["float64"]) > FRIEDMAN_R2_GAP:
        raise AssertionError(f"oao (f): float32 and float64 R^2 differ by "
                             f"{abs(r2['float32'] - r2['float64'])}")
    # each entry's launches from the main-path fit that ran it: TF32 (d)'s,
    # bf16, "highest" and float64 (b)'s, chi-squared (c)'s
    return {"pairs_matvec_tc": launches_d,
            ("pairs_matvec_tc", "bf16"): runs["bf16"]["counts"]["tc"],
            "pairs_matvec": runs["highest"]["counts"]["ffma"],
            ("pairs_matvec", "chi_squared"): launches_c,
            "pairs_matvec_dmma": runs64["batched"]["counts"]["dmma"]}, tables


#: the one-class phase (ROADMAP Queue 1 item 7): nu and C of LIBSVM's -s 2
#: runs, RBF at gamma = 1/d; epsilon EPSILON.  The held-out outliers are
#: ONE_CLASS_OUTLIERS points of N(0, ONE_CLASS_OUTLIER_SCALE^2 I): at d = 784
#: a Gaussian inlier lies ~sqrt(2 d) from another inlier, an outlier
#: ~sqrt((1 + 4) d), so its kernel values are ~exp(-5) against the inliers'
#: ~exp(-2)
ONE_CLASS_NU, ONE_CLASS_HELD_OUT, ONE_CLASS_OUTLIERS = 0.05, 2000, 2000
ONE_CLASS_OUTLIER_SCALE = 2.0
#: the one-class gates: float32 and float64 signs agree on this share of
#: the points (the repo's f32 / f64 rule), the float64 training share of
#: f < 0 within 2 / n of nu (the quantile puts it within 1 / n, a point
#: exactly at rho may flip once more), the float32 one within the share
#: the sign gate leaves, every outlier flagged but 1 %.  The held-out
#: inliers' flag rate is logged, not gated: a training point's score holds
#: its own term alpha_i k(x_i, x_i), a held-out point's does not, so it
#: runs above nu (0.18-0.20 for these classes at 2000-6000 rows in a numpy
#: float64 solve on a CPU)
ONE_CLASS_AGREEMENT = 0.995
#: the CLI one-class run's nu on config 2's files
ONE_CLASS_CLI_NU = 0.1
#: the chi-squared one-class cell's epsilon.  The right-hand side is all
#: ones, the direction of K's largest eigenvalue (~0.37 n here), so each
#: float32 K @ v entry is a sum near 1 over 60000 terms, and their rounding
#: leaves a true residual of ~1e-6 of |b| that the every-50th exact
#: residual shows: at 1e-7 the float32 solve stalled at 2.9e-6 (400
#: iterations, capped), uncapped at 1e-7 and 1e-8 it ran to 5742 iterations
#: and a NaN; 1e-6 stopped after 78 at 8.7e-7, next to the floor (on an
#: H100 80GB HBM3 at 700 W).  1e-5 keeps a factor of ten from it.
#: plssvm_tpu's ridge CG is the same loop with the same stop rule and no
#: stall guard
ONE_CLASS_CHI2_EPSILON = 1e-5
#: the probability phase: every probability row sums to 1 within this (the
#: file's values carry 10 significant digits); the cross-validated accuracy
#: within PROB_CV_GAP of the held-out accuracy (2000 held-out points: its
#: standard deviation at 0.92 is 0.006); the float32 and float64 sigmoids
#: within PROB_F32_REL: A relative, B relative to max(|B|, |A| mean|f|),
#: the scale of B's effect on the sigmoid's argument.  float32 decision
#: values carry TF32's rounding of the Gram products (2^-11 relative, first
#: order) and CG's stop at epsilon; the Newton fit of (A, B) moves with
#: them to first order, so 10x TF32's unit roundoff on the argument's scale
#: is 0.5 %, and 1 % leaves that a factor 2
PROB_ROW_SUM, PROB_CV_GAP, PROB_F32_REL = 1e-6, 0.02, 0.01
#: the SVR noise scale (calibrate_svr_noise, a cross-validated mean
#: absolute residual) within this ratio band of the held-out mean absolute
#: residual of the model it calibrates
PROB_SVR_BAND = (0.8, 1.25)
#: the robust phase: Friedman #1 at ROBUST_N + ROBUST_TEST rows, this share
#: of the training targets shifted by ROBUST_SHIFT standard deviations of
#: the targets; reweighted_fit's refits
ROBUST_N, ROBUST_TEST, ROBUST_SHARE, ROBUST_SHIFT, ROBUST_REFITS = 10000, 2000, 0.05, 6.0, 2


def _one_class_run(label, svm, train, points, counts, epsilon=EPSILON, phase="one-class"):
    """A one-class fit of ``train`` at ONE_CLASS_NU to ``epsilon`` and the
    decision values of ``points`` (a list of arrays), timed, with
    ``counts()`` read after the fit and after the predicts."""
    import plssvm_tpu_torch as port

    port.global_tracker.clear()
    t0 = time.perf_counter()
    model = port.fit_one_class(svm, train, nu=ONE_CLASS_NU, epsilon=epsilon)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fit_counts = counts()
    values = [svm.predict_values(model, port.DataSet(P)) for P in points]
    t2 = time.perf_counter()
    products = 1 + model.n_iter + model.n_iter // 50
    # b = 1, so delta0 = n: the relative residual reached
    reached = np.sqrt(_tracked("cg", "residuum") / train.num_data_points)
    log(phase, f"{label}: {model.n_iter} CG iterations (|r| / |b| {reached:.2e} at "
        f"epsilon {epsilon}), fit {t1 - t0:.3f} s "
        f"({(t1 - t0) / products:.6f} s a product, {products} products: one an "
        f"iteration, every 50th exact residual, the scores), solver "
        f"{_tracked('cg', 'solver')}, predict {sum(len(v) for v in values)} points "
        f"{t2 - t1:.3f} s, launches after the fit {fit_counts}, after the predicts "
        f"{counts()}")
    if not (np.all(np.isfinite(model.alpha)) and np.isfinite(model.rho)
            and all(np.all(np.isfinite(v)) for v in values)):
        raise AssertionError(f"{phase} {label}: non-finite model or values")
    return dict(model=model, values=values, fit_s=t1 - t0, products=products,
                fit_counts=fit_counts, counts=counts())


def _one_class_gates(label, runs, n, flags=True):
    """The one-class gates over the float32 and float64 runs: the training
    share with f < 0, the held-out flag rates, the sign agreement."""
    shares = {k: float(np.mean(r["values"][0] < 0)) for k, r in runs.items()}
    signs = [np.concatenate([v > 0 for v in r["values"]]) for r in runs.values()]
    agree = float(np.mean(signs[0] == signs[1]))
    rates = {k: [float(np.mean(v < 0)) for v in r["values"][1:]] for k, r in runs.items()}
    log("one-class", f"{label}: training share with f < 0 {shares} (nu {ONE_CLASS_NU}, 1/n "
        f"{1 / n:.2e}), held-out flag rates (inliers, outliers) {rates}, float32 / float64 "
        f"sign agreement {agree:.4f} (gate {ONE_CLASS_AGREEMENT})")
    if abs(shares["float64"] - ONE_CLASS_NU) > 2.0 / n \
            or abs(shares["float32"] - ONE_CLASS_NU) > 1.0 / n + 1.0 - ONE_CLASS_AGREEMENT:
        raise AssertionError(f"one-class {label}: training shares {shares} off nu")
    if agree < ONE_CLASS_AGREEMENT:
        raise AssertionError(f"one-class {label}: signs agree on {agree}")
    for rate in rates.values():
        if flags and (rate[1] < 0.99 or rate[1] <= rate[0]):
            raise AssertionError(f"one-class {label}: flag rates {rates}")
    return agree


def phase_one_class(tmp, config2_files, mnist_cell):
    """One-class training (ROADMAP Queue 1 item 7) on the card:

    (a) MNIST width: the 60000 x 784 rows of the mnist-width cell's 10
        Gaussian classes, labels ignored; RBF, gamma 1/d, C = 1, nu =
        ONE_CLASS_NU, ``cg_implicit`` pinned: float32 at "f32" (kernel A on
        the TF32 tile, B to predict), the same rows in float64 (A and B on
        the DMMA tiles); held out ONE_CLASS_HELD_OUT inliers of the cell's
        test rows and ONE_CLASS_OUTLIERS outliers;
    (b) chi-squared: the chi2-width histogram classes at 60000 x 784
        through ``automatic`` (``cg_explicit``: kernel N's symmetric walk
        once, then the sliced cuBLAS K @ v), float32 against float64, at
        ONE_CLASS_CHI2_EPSILON;
    (c) the ring: ``CSVM(devices=["cuda:0"] * 4)`` at config 3's width
        (RBF, 50000 x 500) against one device, float32 (sign agreement >=
        0.995) and float64 at epsilon 1e-10 (>= 0.999);
    (d) the CLIs: config 2's files through ``plssvm-torch-train -s
        one_class -n ONE_CLASS_CLI_NU`` and ``plssvm-torch-predict``.

    Returns the launches of the main-path runs."""
    import plssvm_tpu_torch as port
    from plssvm_tpu_torch.ops import gram_matvec, kernel_matrix, matvec

    def gram_counts():
        return dict(A_tc=gram_matvec.sym_tc_launches, B_tc=gram_matvec.rect_tc_launches,
                    A_dmma=gram_matvec.sym_dmma_launches,
                    B_dmma=gram_matvec.rect_dmma_launches,
                    ffma=gram_matvec.sym_launches + gram_matvec.rect_launches,
                    plain=matvec.sym_plain_calls + matvec.rect_plain_calls)

    launches = {}
    # (a) MNIST width
    train32, test32 = mnist_cell["make"](np.float32)
    X = np.asarray(train32.data)
    n = X.shape[0]
    inliers = np.asarray(test32.data)[:ONE_CLASS_HELD_OUT]
    rng = np.random.default_rng(SEED + 50)
    outliers = rng.normal(size=(ONE_CLASS_OUTLIERS, X.shape[1])) * ONE_CLASS_OUTLIER_SCALE
    runs = {}
    for dtype in (np.float32, np.float64):
        name = np.dtype(dtype).name
        svm = port.CSVM(backend="cuda", device="cuda", dtype=dtype, kernel_type="rbf",
                        cost=1.0, solver="cg_implicit")
        _automatic("one-class", f"(a) rbf {n}x{X.shape[1]} {name}", n + 1, X.shape[1], "rbf",
                   dtype=dtype)
        gram_matvec.reset_counts()
        train = train32 if dtype == np.float32 else port.DataSet(X, dtype=np.float64)
        run = _one_class_run(f"(a) MNIST width rbf {name}", svm, train,
                             [X, inliers, outliers], gram_counts)
        runs[name] = run
        sym, rect = ("A_tc", "B_tc") if dtype == np.float32 else ("A_dmma", "B_dmma")
        c, fc = run["counts"], run["fit_counts"]
        if fc[sym] != run["products"] or c[rect] <= 0 or c["ffma"] or c["plain"] \
                or (c["A_dmma"] + c["B_dmma"] if dtype == np.float32
                    else c["A_tc"] + c["B_tc"]):
            raise AssertionError(f"one-class (a) {name}: not through kernel A's "
                                 f"{'TF32' if dtype == np.float32 else 'DMMA'} tile and B "
                                 f"only: {c}")
        key = "" if dtype == np.float32 else "_dmma"
        launches[f"gram_matvec_sym{key or '_tc'}"] = fc[sym]
        launches[f"gram_matvec_rect{key or '_tc'}"] = c[rect] - fc[rect]
    _one_class_gates("(a) MNIST width rbf", runs, n)
    del runs, train32, test32

    # (b) chi-squared through automatic: kernel N and the stored K
    Xc, _, Xc_test, _, gamma, _, _ = _chi2_width_data()
    Xc_out = Xc_test[:ONE_CLASS_HELD_OUT]
    runs = {}
    for dtype in (np.float32, np.float64):
        name = np.dtype(dtype).name
        svm = port.CSVM(backend="cuda", device="cuda", dtype=dtype, kernel_type="chi_squared",
                        gamma=gamma, cost=1.0)
        kernel_matrix.reset_counts()
        train = port.DataSet(Xc, dtype=dtype)
        run = _one_class_run(f"(b) chi-squared {Xc.shape[0]}x{Xc.shape[1]} {name} automatic",
                             svm, train, [Xc, Xc_out],
                             lambda: dict(N=kernel_matrix.sym_launches,
                                          N_rect=kernel_matrix.rect_launches,
                                          build_ms=_tracked("cg", "kernel_matrix_build_time")),
                             epsilon=ONE_CLASS_CHI2_EPSILON)
        del train
        torch.cuda.empty_cache()
        runs[name] = run
        if _tracked("cg", "solver") != "cg_explicit" or run["fit_counts"]["N"] != 1:
            raise AssertionError(f"one-class (b) {name}: automatic did not build K once "
                                 f"with kernel N: {run['fit_counts']}")
        launches[f"kernel_matrix_sym{'' if dtype == np.float32 else '_f64'}_one_class"] = 1
    _one_class_gates("(b) chi-squared", runs, Xc.shape[0], flags=False)
    del runs, Xc, Xc_test

    # (c) the ring at config 3's width
    cell = _config3_rbf_cell()
    for dtype in (np.float32, np.float64):
        name = np.dtype(dtype).name
        train, test = cell["make"](dtype)
        points = [np.asarray(train.data), np.asarray(test.data)]
        eps = EPSILON if dtype == np.float32 else RING_F64_EPSILON
        fits = {}
        for where, devices in (("one device", None), ("ring", ["cuda:0"] * RING_SHARDS)):
            place = dict(device="cuda") if devices is None else dict(devices=devices)
            svm = port.CSVM(backend="cuda", dtype=dtype, kernel_type="rbf", cost=1.0,
                            solver="cg_implicit", **place)
            gram_matvec.reset_counts()
            port.global_tracker.clear()
            t0 = time.perf_counter()
            model = port.fit_one_class(svm, train, nu=ONE_CLASS_NU, epsilon=eps)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            counts = _ring_counts("rbf", False, dtype)
            values = [svm.predict_values(model, port.DataSet(P, dtype=dtype)) for P in points]
            fits[where] = dict(model=model, values=values, fit_s=t1 - t0, counts=counts)
            log("one-class", f"(c) config 3 width rbf {name} {where}: {model.n_iter} CG "
                f"iterations, fit {t1 - t0:.3f} s, launches sym / dual / rows {counts[1]}, "
                f"other tile {counts[2]}, plain calls {counts[3]}")
        ring, one = fits["ring"], fits["one device"]
        products = ring["model"].n_iter + ring["model"].n_iter // 50 + 1
        steps = (RING_SHARDS - 1) // 2
        _, counts, other, plain = ring["counts"]
        if counts != [RING_SHARDS * products, RING_SHARDS * steps * products,
                      RING_SHARDS * products * (RING_SHARDS % 2 == 0)] or other or plain:
            raise AssertionError(f"one-class (c) {name}: the ring's launches {counts}, other "
                                 f"{other}, plain {plain} for {products} products")
        agree = float(np.mean(np.concatenate([a > 0 for a in ring["values"]])
                              == np.concatenate([b > 0 for b in one["values"]])))
        d_alpha = float(np.max(np.abs(np.asarray(ring["model"].alpha, dtype=np.float64)
                                      - np.asarray(one["model"].alpha, dtype=np.float64))))
        need = 0.995 if dtype == np.float32 else 0.999
        log("one-class", f"(c) {name} ring against one device: sign agreement {agree:.4f} "
            f"(gate {need}), max|d alpha| {d_alpha:.3e}, |d rho| "
            f"{abs(ring['model'].rho - one['model'].rho):.3e}")
        if agree < need:
            raise AssertionError(f"one-class (c) {name}: ring and one device agree on {agree}")
        if dtype == np.float32:
            launches["gram_matvec_dual"] = counts[1]
        else:
            launches["gram_matvec_dual_f64"] = counts[1]
        del train, test, fits

    # (d) the CLIs on config 2's files: the training file predicted, whose
    # flag rate the quantile fixes, and the test file
    (train_file, _), (test_file, _) = config2_files
    gram_matvec.reset_counts()
    fit_s, predict_s, predicted, io = _cli_fit_predict(
        "one-class-cli", train_file, train_file, tmp,
        ["-s", "one_class", "-n", str(ONE_CLASS_CLI_NU), "-t", "2", "-e", str(EPSILON)])
    rate = float(np.mean(predicted == -1))
    n_cli = len(predicted)
    _, _, held_out, _ = _cli_fit_predict(
        "one-class-cli-test", train_file, test_file, tmp,
        ["-s", "one_class", "-n", str(ONE_CLASS_CLI_NU), "-t", "2", "-e", str(EPSILON)])
    log("one-class", f"(d) config 2 through plssvm-torch-train -s one_class -n "
        f"{ONE_CLASS_CLI_NU} and plssvm-torch-predict: fit (CLI) {fit_s:.3f} s, predict (CLI, "
        f"the training file) {predict_s:.3f} s, training flag rate {rate:.4f}, test flag rate "
        f"{float(np.mean(held_out == -1)):.4f}, kernel A / B launches "
        f"({gram_matvec.sym_tc_launches}, {gram_matvec.rect_tc_launches}); native parses, "
        f"writes {io['native']}")
    if set(np.unique(predicted)) - {-1, 1} \
            or abs(rate - ONE_CLASS_CLI_NU) > 1.0 / n_cli + 1.0 - ONE_CLASS_AGREEMENT:
        raise AssertionError(f"one-class (d): predictions {np.unique(predicted)}, flag rate "
                             f"{rate}")
    if io["native"] != (3, 1) or gram_matvec.sym_tc_launches <= 0 \
            or gram_matvec.rect_tc_launches <= 0:
        raise AssertionError(f"one-class (d): native {io['native']}, launches A "
                             f"{gram_matvec.sym_tc_launches} B {gram_matvec.rect_tc_launches}")
    return launches


def _launch_counts():
    """The Gram, distance and pairs kernels' launches since their last
    reset, and the plain versions' calls."""
    from plssvm_tpu_torch.ops import gram_matmat, gram_matvec, matvec, pairs

    return dict(A=gram_matvec.sym_tc_launches + gram_matvec.sym_dmma_launches,
                B=gram_matvec.rect_tc_launches + gram_matvec.rect_dmma_launches,
                C=gram_matmat.sym_tc_launches + gram_matmat.sym_dmma_launches,
                D=gram_matmat.rect_tc_launches + gram_matmat.rect_dmma_launches,
                O=pairs.tc_launches + pairs.dmma_launches + pairs.launches,
                ffma=(gram_matvec.sym_launches + gram_matvec.rect_launches
                      + gram_matmat.sym_launches + gram_matmat.rect_launches),
                plain=sum(getattr(matvec, n) for n in (
                    "sym_plain_calls", "rect_plain_calls", "sym_matmat_plain_calls",
                    "rect_matmat_plain_calls")) + pairs.plain_calls)


def _reset_launch_counts():
    from plssvm_tpu_torch.ops import gram_matmat, gram_matvec, pairs

    # the Gram modules' resets zero their plain versions' counts too
    for module in (gram_matvec, gram_matmat, pairs):
        module.reset_counts()


def _cli_probability(tmp, label, train_file, test_file, labels, flags):
    """``plssvm-torch-train --probability`` then ``plssvm-torch-predict
    --probability`` on the card: the svm-predict -b 1 file parsed into
    (labels, probabilities), the row sums and the labels' accuracy gated;
    returns the log fields."""
    import plssvm_tpu_torch as port
    from plssvm_tpu_torch.cli import predict as predict_cli
    from plssvm_tpu_torch.cli import train as train_cli

    model_file = os.path.join(tmp, f"prob-{label}.model")
    out_file = os.path.join(tmp, f"prob-{label}.predict")
    common = ["-b", "cuda", "-p", "gpu", "-q"]
    _reset_launch_counts()
    t0 = time.perf_counter()
    rc = train_cli.main(common + ["--solver", "cg_implicit", "--probability", "-t", "2",
                                  "-c", "1", "-e", str(EPSILON)] + flags
                        + [train_file, model_file])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fit_counts = _launch_counts()
    rc_predict = predict_cli.main(common + ["--probability", test_file, model_file, out_file])
    t2 = time.perf_counter()
    if rc != 0 or rc_predict != 0:
        raise AssertionError(f"probability {label}: train rc {rc}, predict rc {rc_predict}")
    with open(out_file, encoding="utf-8") as fh:
        header = fh.readline().split()
        rows = [line.split() for line in fh]
    predicted = np.asarray([int(r[0]) for r in rows])
    probs = np.asarray([r[1:] for r in rows], dtype=np.float64)
    sums = np.abs(probs.sum(axis=1) - 1.0).max()
    accuracy = float(np.mean(predicted == labels))
    prob_lines = [ln.split()[0] for ln in open(model_file, encoding="utf-8")
                  if ln.startswith(("probA", "probB"))]
    log("probability", f"{label} --probability (CLI): fit and calibration {t1 - t0:.3f} s, "
        f"predict {t2 - t1:.3f} s, header {header[:3]}..., {probs.shape[1]} probability "
        f"columns, max|row sum - 1| {sums:.2e}, accuracy of the -b 1 labels {accuracy:.4f}, "
        f"model lines {prob_lines}, launches after the fit {fit_counts}, after the predict "
        f"{_launch_counts()}")
    if header[0] != "labels" or sums > PROB_ROW_SUM or not np.all(probs >= 0.0) \
            or prob_lines != ["probA", "probB"]:
        raise AssertionError(f"probability {label}: header {header}, row sums {sums}, "
                             f"model lines {prob_lines}")
    return dict(accuracy=accuracy, fit_counts=fit_counts, counts=_launch_counts(),
                fit_s=t1 - t0)


def _calibrate_in_memory(label, dtype, train, test, labels, **params):
    """A fit and ``calibrate_model`` (5 folds) in ``dtype`` through CSVM,
    the test points' probabilities: returns (prob_a, prob_b, mean|f|,
    probabilities, seconds)."""
    import plssvm_tpu_torch as port

    svm = port.CSVM(backend="cuda", device="cuda", dtype=dtype, cost=1.0,
                    solver="cg_implicit", **params)
    _reset_launch_counts()
    t0 = time.perf_counter()
    model = svm.fit(train, epsilon=EPSILON)
    prob_a, prob_b = port.calibrate_model(svm, model, train, n_folds=5, epsilon=EPSILON)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fit_counts = _launch_counts()
    values = svm.predict_values(model, test)
    probs = port.predict_probabilities(model, values)
    sums = float(np.abs(probs.sum(axis=1) - 1.0).max())
    order = np.asarray(model.data.different_labels)
    accuracy = float(np.mean(order[np.argmax(probs, axis=1)] == labels))
    log("probability", f"{label} {np.dtype(dtype).name} calibrate_model (5 folds): fit and "
        f"calibration {t1 - t0:.3f} s, probA {np.round(prob_a, 5).tolist()}, probB "
        f"{np.round(prob_b, 5).tolist()}, max|row sum - 1| {sums:.2e}, accuracy of the "
        f"argmax {accuracy:.4f}, launches after the calibration {fit_counts}")
    if sums > PROB_ROW_SUM or fit_counts["ffma"] or fit_counts["plain"]:
        raise AssertionError(f"probability {label}: row sums {sums}, launches {fit_counts}")
    return prob_a, prob_b, float(np.mean(np.abs(values))), probs, accuracy, fit_counts


def phase_probability(tmp, config2_files, mc_files, e2e_predicted, mnist_cell):
    """Probability calibration and cross-validation (ROADMAP Queue 1 item
    7) on the card:

    (a) ``--probability`` through both CLIs on config 2's files (binary:
        kernels A and B), on the 10-class CLI files one-vs-all (C and D)
        and ``--classification oao`` (O for the model and for the
        cross-validation, each fold's 45 pair machines one batched solve
        and their held-out values one product through D; no A): every row
        of the -b 1 file sums to 1 within PROB_ROW_SUM;
    (b) ``--cross_validation 5`` on config 2's files: the CV accuracy within
        PROB_CV_GAP of the held-out accuracy of phase e2e's model;
    (c) ``calibrate_model`` (5 folds) of the MNIST-width one-vs-all model
        (C and D);
    (d) float32 against float64 calibrations of config 2 through CSVM:
        (A, B) within PROB_F32_REL;
    (e) ``-s epsilon_svr --probability`` on Friedman #1
        (``calibrate_svr_noise``): the noise line's sigma within
        PROB_SVR_BAND of the held-out mean absolute residual.

    Returns the launches of the main-path runs."""
    import contextlib
    import io as _io

    import plssvm_tpu_torch as port
    from plssvm_tpu_torch.cli import predict as predict_cli
    from plssvm_tpu_torch.cli import train as train_cli

    launches = {}
    (train_file, _), (test_file, test_labels) = config2_files
    # (a) the CLIs
    runs = {"config 2": _cli_probability(tmp, "config2", train_file, test_file, test_labels,
                                         [])}
    mc_train, mc_test = mc_files["mc_train"][0], mc_files["mc_test"][0]
    for label, flags in (("10 classes one-vs-all", []),
                         ("10 classes one-vs-one", ["--classification", "oao"])):
        runs[label] = _cli_probability(tmp, label.replace(" ", "-"), mc_train, mc_test,
                                       mc_files["mc_test"][1], flags)
    binary, oaa, oao = (runs[k]["fit_counts"] for k in runs)
    if binary["A"] <= 0 or binary["B"] <= 0 or oaa["C"] <= 0 or oaa["D"] <= 0 \
            or oao["O"] <= 0 or oao["D"] <= 0 or oao["A"] != 0 \
            or any(r["counts"]["ffma"] + r["counts"]["plain"] for r in runs.values()):
        raise AssertionError(f"probability (a): launches {[r['counts'] for r in runs.values()]}")
    if runs["config 2"]["accuracy"] < ACCURACY_FLOOR \
            or min(runs[k]["accuracy"] for k in list(runs)[1:]) < MC_ACCURACY_FLOOR:
        raise AssertionError(f"probability (a): accuracies "
                             f"{[r['accuracy'] for r in runs.values()]}")
    launches["gram_matvec_sym_tc"] = binary["A"]
    launches["gram_matmat_sym_tc"] = oaa["C"]
    launches["pairs_matvec_tc"] = oao["O"]

    # (b) --cross_validation 5 on config 2
    held_out = float(np.mean(e2e_predicted == test_labels))
    out = _io.StringIO()
    _reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = train_cli.main(["-b", "cuda", "-p", "gpu", "--verbosity", "libsvm", "--solver",
                             "cg_implicit", "--cross_validation", "5", "-t", "2", "-c", "1",
                             "-e", str(EPSILON), train_file, os.path.join(tmp, "cv.model")])
    t1 = time.perf_counter()
    port.set_verbosity("quiet")
    lines = [ln for ln in out.getvalue().splitlines() if ln.startswith("Cross Validation")]
    cv = float(lines[0].split("=")[1].strip().rstrip("%")) / 100.0 if lines else float("nan")
    counts = _launch_counts()
    log("probability", f"(b) config 2 --cross_validation 5 (CLI): {t1 - t0:.3f} s, CV "
        f"accuracy {cv:.4f}, held-out accuracy of the e2e model {held_out:.4f}, gap "
        f"{abs(cv - held_out):.4f} (gate {PROB_CV_GAP}), launches {counts}")
    if rc != 0 or os.path.exists(os.path.join(tmp, "cv.model")) \
            or not abs(cv - held_out) <= PROB_CV_GAP or counts["A"] <= 0 or counts["B"] <= 0:
        raise AssertionError(f"probability (b): rc {rc}, CV accuracy {cv}, held out "
                             f"{held_out}, launches {counts}")

    # (c) the MNIST-width one-vs-all model
    train_w, test_w = mnist_cell["make"](np.float32)
    _, _, _, _, acc_w, counts_w = _calibrate_in_memory(
        "(c) MNIST width 10 classes", np.float32, train_w, test_w, mnist_cell["labels"],
        kernel_type="rbf")
    if acc_w < MC_ACCURACY_FLOOR or counts_w["C"] <= 0 or counts_w["D"] <= 0:
        raise AssertionError(f"probability (c): accuracy {acc_w}, launches {counts_w}")
    launches["gram_matmat_rect_tc"] = counts_w["D"]
    del train_w, test_w

    # (d) float32 against float64 on config 2
    cal = {}
    for dtype in (np.float32, np.float64):
        train, test = (port.DataSet(f, dtype=dtype) for f in (train_file, test_file))
        cal[dtype] = _calibrate_in_memory("(d) config 2", dtype, train, test, test_labels,
                                          kernel_type="rbf")
    (a32, b32, _, p32, _, _), (a64, b64, f64, p64, _, c64) = cal[np.float32], cal[np.float64]
    scale = max(abs(float(b64[0])), abs(float(a64[0])) * f64)
    d_a = abs(float(a32[0] - a64[0])) / abs(float(a64[0]))
    d_b = abs(float(b32[0] - b64[0])) / scale
    log("probability", f"(d) config 2 float32 against float64: A {float(a32[0]):.6f} / "
        f"{float(a64[0]):.6f} (relative {d_a:.2e}), B {float(b32[0]):.6f} / {float(b64[0]):.6f} "
        f"(relative to {scale:.4f}: {d_b:.2e}), gate {PROB_F32_REL}; max|d P| on the test "
        f"points {float(np.abs(p32 - p64).max()):.2e}; float64 launches {c64}")
    if d_a > PROB_F32_REL or d_b > PROB_F32_REL:
        raise AssertionError(f"probability (d): float32 and float64 sigmoids differ: A {d_a}, "
                             f"B {d_b}")
    launches["gram_matvec_sym_dmma"] = c64["A"]

    # (e) the SVR noise scale on Friedman #1
    frng = np.random.default_rng(SEED + 41)
    X, y = _friedman1(frng, FRIEDMAN_N + FRIEDMAN_TEST)
    svr_train = os.path.join(tmp, "friedman_prob_train.libsvm")
    svr_test = os.path.join(tmp, "friedman_prob_test.libsvm")
    port.DataSet(X[:FRIEDMAN_N], y[:FRIEDMAN_N], regression=True).save(svr_train)
    port.DataSet(X[FRIEDMAN_N:], y[FRIEDMAN_N:], regression=True).save(svr_test)
    model_file = os.path.join(tmp, "svr-prob.model")
    out_file = os.path.join(tmp, "svr-prob.predict")
    common = ["-b", "cuda", "-p", "gpu"]
    _reset_launch_counts()
    t0 = time.perf_counter()
    rc = train_cli.main(common + ["-q", "--solver", "cg_implicit", "-s", "epsilon_svr", "-t",
                                  "2", "-c", "10", "-e", str(FRIEDMAN_EPSILON), "--probability",
                                  svr_train, model_file])
    t1 = time.perf_counter()
    out = _io.StringIO()
    with contextlib.redirect_stdout(out):
        rc_predict = predict_cli.main(common + ["--verbosity", "libsvm", "--probability",
                                                svr_test, model_file, out_file])
    port.set_verbosity("quiet")
    noise = [ln for ln in out.getvalue().splitlines() if "sigma=" in ln]
    sigma = float(noise[0].split("sigma=")[1]) if noise else float("nan")
    values = np.loadtxt(out_file)
    mae = float(np.mean(np.abs(values - y[FRIEDMAN_N:])))
    counts = _launch_counts()
    log("probability", f"(e) Friedman #1 -s epsilon_svr --probability (CLI): fit and noise "
        f"calibration {t1 - t0:.3f} s, sigma {sigma:.6f}, held-out mean |residual| "
        f"{mae:.6f}, ratio {sigma / mae:.4f} (band {PROB_SVR_BAND}), launches {counts}")
    if rc != 0 or rc_predict != 0 or not PROB_SVR_BAND[0] <= sigma / mae <= PROB_SVR_BAND[1] \
            or counts["A"] <= 0 or counts["B"] <= 0:
        raise AssertionError(f"probability (e): rc {rc}/{rc_predict}, sigma {sigma}, mae {mae}")
    return launches


def phase_robust():
    """Robust LS-SVR (ROADMAP Queue 1 item 7): Friedman #1 at ROBUST_N x
    FRIEDMAN_D with ROBUST_SHARE of the training targets shifted by
    ROBUST_SHIFT standard deviations of the targets, all upward (gross
    errors in one direction: a stuck-high sensor) and, logged beside,
    each up or down at random; ``reweighted_fit`` (ROBUST_REFITS
    warm-started refits with Hampel weights) against the plain fit, RBF, C
    = 10, float32 on kernels A and B; kernel A launched once per product of
    the fits (a warm start takes two initial products).  The gate: with the
    one-sided shifts the robust fit's held-out R^2 against the clean
    targets (the formula without noise) is above the plain fit's.  The
    symmetric shifts are logged, not gated: at 10000 rows the plain fit
    averages them away and the reweighting costs more than it saves (on an
    H100 80GB HBM3 at 700 W: plain 0.9249, robust 0.9187; one-sided there:
    plain 0.8293, robust 0.9128).  ``tools/robust_witness.py`` fits the
    same data with plssvm_tpu in float64 on a CPU and reads the same four
    digits on both sides."""
    import plssvm_tpu_torch as port

    rng = np.random.default_rng(SEED + 60)
    X, y_noisy = _friedman1(rng, ROBUST_N + ROBUST_TEST)
    clean = (10.0 * np.sin(np.pi * X[:, 0] * X[:, 1]) + 20.0 * (X[:, 2] - 0.5) ** 2
             + 10.0 * X[:, 3] + 5.0 * X[:, 4])
    bad = rng.choice(ROBUST_N, int(ROBUST_SHARE * ROBUST_N), replace=False)
    signs = rng.choice([-1.0, 1.0], len(bad))
    test = port.DataSet(X[ROBUST_N:], clean[ROBUST_N:], regression=True, dtype=np.float32)
    svm = port.CSVM(backend="cuda", device="cuda", dtype=np.float32, kernel_type="rbf",
                    cost=10.0, solver="cg_implicit")
    launches = {}
    for side, sign in (("one-sided", 1.0), ("symmetric", signs)):
        y = y_noisy[:ROBUST_N].copy()
        y[bad] += ROBUST_SHIFT * y.std() * sign
        train = port.DataSet(X[:ROBUST_N], y, regression=True, dtype=np.float32)
        _reset_launch_counts()
        port.global_tracker.clear()
        t0 = time.perf_counter()
        plain = svm.fit(train, epsilon=FRIEDMAN_EPSILON)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        robust = port.reweighted_fit(svm, train, iterations=ROBUST_REFITS,
                                     epsilon=FRIEDMAN_EPSILON)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts = _launch_counts()
        its = [v for k, v in port.global_tracker.entries()["cg"] if k == "iterations"]
        # each fit's products; a warm-started refit takes one more initial
        # product (the cold start's residual anchors its stop target)
        products = sum(1 + it + it // 50 for it in its) + ROBUST_REFITS
        r2 = (svm.score(plain, test), svm.score(robust, test))
        log("robust", f"Friedman #1 {ROBUST_N}x{FRIEDMAN_D}, {len(bad)} targets shifted by "
            f"{ROBUST_SHIFT} sd, {side}: plain fit {its[0]} iterations {t1 - t0:.3f} s, "
            f"reweighted_fit ({ROBUST_REFITS} warm-started refits: iterations {its[1:]}) "
            f"{t2 - t1:.3f} s; held-out R^2 against the clean targets: plain {r2[0]:.4f}, "
            f"robust {r2[1]:.4f}{' (gated)' if side == 'one-sided' else ' (logged)'}; "
            f"launches {counts} (A: {products} products)")
        if counts["A"] != products or counts["B"] < ROBUST_REFITS or counts["ffma"] \
                or counts["plain"]:
            raise AssertionError(f"robust {side}: launches {counts}, want A {products}")
        if side == "one-sided":
            launches = {"gram_matvec_sym_tc": counts["A"], "gram_matvec_rect_tc": counts["B"]}
            if not r2[1] > r2[0]:
                raise AssertionError(f"robust: R^2 {r2[1]} not above the plain fit's {r2[0]}")
    return launches


#: the compact phase (ROADMAP Queue 1 item 9): the fixed-size fits'
#: landmarks at MNIST width and chi2-width, and of the streamed CLI fits;
#: the pruned CLI fits' support vectors
COMPACT_M, COMPACT_CLI_M, COMPACT_MAX_SV = 2048, 1024, 1000
#: sparse.nystroem_fit's row block: 60000 rows are ceil(60000 / 4096) = 15
#: blocks, each one K(X_blk, Z) launch of kernel N's rect walk for the
#: distance kinds
COMPACT_ROW_BLOCK = 4096
#: the streamed CLI fits' decision values against the in-memory fits' on
#: the same landmarks, relative to max|f|: tests/test_torch_sparse.py's
#: float32 tolerance (FLOAT32_STREAM_TOL; the sums in another order read
#: 1.5e-6 to 7e-6 there)
COMPACT_STREAM_TOL = 1e-4
#: the compact phase's nu for the streamed one-class CLI fit (the one-class
#: phase's)
COMPACT_NU = 0.05
#: the sklearn phase: the facade and the CSVM-level call fit the same system
#: apart, and the kernels' atomics may reorder a sum, so their values are
#: logged (bit for bit or not); labels equal on every point, the sigmoids
#: (A, B) within this share of max(|A|, |B|), SVR's R^2 within
#: FRIEDMAN_R2_GAP (two float64 solves stopped at epsilon 1e-6 may stop an
#: iteration apart)
FACADE_REL = 1e-6


def _nystroem_counts():
    """Kernel N's (symmetric, rect) launches and plain calls since their
    last reset, beside the Gram kernels' (``_launch_counts``)."""
    from plssvm_tpu_torch.ops import kernel_matrix

    return dict(_launch_counts(), N=(kernel_matrix.sym_launches, kernel_matrix.rect_launches),
                N_plain=kernel_matrix.plain_calls)


def _nystroem_run(label, svm, train, test, labels):
    """``nystroem_fit`` of ``train`` on COMPACT_M stratified landmarks and
    the predict of ``test``, timed, with the fit's phases from the tracker
    (``basis_ms``: K_mm and its inverse square root on the host;
    ``reduce_ms``: the row blocks; ``solve_ms``: the bordered solve) and
    the launches after the fit and after the predict."""
    import plssvm_tpu_torch as port
    from plssvm_tpu_torch.ops import kernel_matrix

    port.global_tracker.clear()
    _reset_launch_counts()
    kernel_matrix.reset_counts()
    t0 = time.perf_counter()
    model, idx = port.nystroem_fit(svm, train, n_landmarks=COMPACT_M, return_indices=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fit_counts = _nystroem_counts()
    predicted = svm.predict(model, test)
    t2 = time.perf_counter()
    phases = {k: _tracked("nystroem", k) for k in ("basis_ms", "reduce_ms", "solve_ms")}
    blocks = _tracked("nystroem", "row_blocks")
    accuracy = float(np.mean(predicted == labels))
    alpha = np.asarray(model.alpha)
    model_bytes = model.support_vectors.nbytes + alpha.nbytes
    log("compact", f"{label}: {COMPACT_M} landmarks, fit {t1 - t0:.3f} s (basis "
        f"{phases['basis_ms'] / 1000:.3f} s, reduction of {blocks} row blocks "
        f"{phases['reduce_ms'] / 1000:.3f} s, host solve {phases['solve_ms'] / 1000:.3f} s), "
        f"predict {len(labels)} points {t2 - t1:.3f} s, accuracy {accuracy:.4f}; model "
        f"{model.num_support_vectors} SVs, {model_bytes} bytes (an exact fit: "
        f"{train.num_data_points} SVs, {train.data.nbytes + train.num_data_points * alpha.nbytes // len(alpha)} "
        f"bytes); launches after the fit {fit_counts}, after the predict {_nystroem_counts()}")
    if not (np.all(np.isfinite(alpha)) and np.all(np.isfinite(model.rho))):
        raise AssertionError(f"compact {label}: non-finite model")
    return dict(model=model, idx=idx, predicted=predicted, accuracy=accuracy, blocks=blocks,
                fit_s=t1 - t0, fit_counts=fit_counts, counts=_nystroem_counts())


def _compact_cli(tmp, label, train_file, test_file, labels, flags):
    """A compact fit through ``plssvm-torch-train`` (``flags``) and its
    predict through ``plssvm-torch-predict`` at config 2's epsilon; the
    fits' CG iterations (one tracker entry a fit: the first fit and each
    pruning round's refit) and the launches after both."""
    _reset_launch_counts()
    fit_s, predict_s, predicted, io = _cli_fit_predict(
        f"compact-{label.replace(' ', '-')}", train_file, test_file, tmp,
        ["-t", "2", "-c", "1", "-e", str(EPSILON)] + flags)
    import plssvm_tpu_torch as port

    its = [v for k, v in port.global_tracker.entries().get("cg", []) if k == "iterations"]
    counts = _launch_counts()
    accuracy = float(np.mean(predicted == labels))
    return dict(fit_s=fit_s, predict_s=predict_s, predicted=predicted, io=io, its=its,
                counts=counts, accuracy=accuracy)


def _lexsorted(rows):
    rows = np.asarray(rows)
    return rows[np.lexsort(rows.T[::-1])]


def phase_compact(tmp, config2_files, mc_files, mnist_cell):
    """Compact models (ROADMAP Queue 1 item 9, sparse.py) on the card:

    (a) Nystroem at MNIST width: the mnist-width cell's 10 Gaussian classes,
        60000 x 784, RBF, COMPACT_M class-stratified landmarks, float32
        (K(X_blk, Z) on cuBLAS in TF32 at "f32", the projections in full
        float32) and float64; the fit's basis, reduction and host solve
        apart, accuracy beside the exact fit's (floor MC_ACCURACY_FLOOR),
        float32 / float64 label agreement >= ONE_CLASS_AGREEMENT (the
        repo's f32 / f64 gate), the model's size; predict on D;
    (b) Nystroem, chi-squared, at chi2-width (the histogram classes, 60000 x
        784, float32, COMPACT_M landmarks): kernel N's symmetric walk once
        (K_mm) and its rect walk once a row block (>= 15), a row block of N
        held against its plain version at the cell's shape afterwards
        (outside the counted run); predict on H;
    (c) ``plssvm-torch-train --max_sv COMPACT_MAX_SV`` on config 2's files
        (binary, A at TF32) and on the 10-class CLI files (one-vs-all, C):
        the pruning rounds, A / C launched once a product of every fit
        (a warm-started refit one more: its cold start's residual), the
        model's COMPACT_MAX_SV SVs; accuracy logged beside the exact fits'
        and not gated: pruning keeps the largest |alpha|, which in LS-SVM are
        the largest training errors, and on these overlapping classes the
        survivors predict far worse (``tools/compact_witness.py``: plssvm_tpu
        in float64 on a CPU loses as much on the same draws);
    (d) ``--nystroem COMPACT_CLI_M --streaming`` on the 10-class CLI files
        and ``-s one_class --nystroem COMPACT_CLI_M --streaming``: the
        landmarks those of the in-memory fit (the same draw), decision values
        within COMPACT_STREAM_TOL of max|f|;
    (e) (a) with ``devices=["cuda:0"] * 4``, each shard's rows on its own
        reduction, against one device: the ring's gates, >= 0.999 float64,
        >= 0.995 float32.

    Returns the launches of the counted runs."""
    import plssvm_tpu_torch as port
    from plssvm_tpu_torch.ops import kernel_matrix
    from plssvm_tpu_torch.parameter import KernelFunctionType as K
    from plssvm_tpu_torch.sparse import _stratified_landmarks

    launches = {}
    # (a) MNIST width, float32 and float64
    runs = {}
    for dtype in (np.float32, np.float64):
        train, test = mnist_cell["make"](dtype)
        svm = port.CSVM(backend="cuda", device="cuda", dtype=dtype, kernel_type="rbf")
        runs[np.dtype(dtype).name] = _nystroem_run(
            f"(a) MNIST width rbf {np.dtype(dtype).name}", svm, train, test,
            mnist_cell["labels"])
    f32, f64 = runs["float32"], runs["float64"]
    exact = mnist_cell["implicit"]["accuracy"]
    agree = float(np.mean(f32["predicted"] == f64["predicted"]))
    log("compact", f"(a) accuracy float32 {f32['accuracy']:.4f}, float64 {f64['accuracy']:.4f} "
        f"(the exact 60000-SV fit {exact:.4f}, floor {MC_ACCURACY_FLOOR}); float32 / float64 "
        f"label agreement {agree:.4f} (gate {ONE_CLASS_AGREEMENT}); the same landmarks "
        f"{bool(np.array_equal(f32['idx'], f64['idx']))}")
    if not np.array_equal(f32["idx"], f64["idx"]):
        raise AssertionError("compact (a): float32 and float64 drew other landmarks")
    if min(f32["accuracy"], f64["accuracy"]) < MC_ACCURACY_FLOOR or agree < ONE_CLASS_AGREEMENT:
        raise AssertionError(f"compact (a): accuracy {f32['accuracy']}, {f64['accuracy']}, "
                             f"agreement {agree}")
    for run in runs.values():
        c = run["counts"]
        if run["fit_counts"]["D"] or c["D"] != 1 or c["ffma"] or c["plain"] or c["N"] != (0, 0):
            raise AssertionError(f"compact (a): launches {c}")
    launches["gram_matmat_rect_tc"] = f32["counts"]["D"]
    launches["gram_matmat_rect_dmma"] = f64["counts"]["D"]

    # (e) the same fits row-sharded over four entries of cuda:0
    for name, floor in (("float32", 0.995), ("float64", 0.999)):
        dtype = np.dtype(name)
        train, test = mnist_cell["make"](dtype)
        ring = port.CSVM(backend="cuda", devices=["cuda:0"] * RING_SHARDS, dtype=dtype,
                         kernel_type="rbf")
        run = _nystroem_run(f"(e) MNIST width rbf {name}, {RING_SHARDS} shards of cuda:0",
                            ring, train, test, mnist_cell["labels"])
        one = runs[name]
        agree = float(np.mean(run["predicted"] == one["predicted"]))
        d_alpha = float(np.max(np.abs(np.asarray(run["model"].alpha, np.float64)
                                      - np.asarray(one["model"].alpha, np.float64))))
        log("compact", f"(e) {name}: {RING_SHARDS} shards against one device: fit "
            f"{run['fit_s']:.3f} s against {one['fit_s']:.3f} s, {run['blocks']} row blocks "
            f"against {one['blocks']}, max|d alpha| {d_alpha:.3e}, label agreement "
            f"{agree:.4f} (gate {floor})")
        if agree < floor or not np.array_equal(run["idx"], one["idx"]):
            raise AssertionError(f"compact (e) {name}: agreement {agree}")
    del runs, f32, f64, train, test

    # (b) chi-squared at chi2-width: kernel N
    X, y, X_test, y_test, gamma, bayes, made_s = _chi2_width_data()
    svm = port.CSVM(backend="cuda", device="cuda", dtype=np.float32, kernel_type="chi_squared",
                    gamma=gamma)
    run = _nystroem_run("(b) chi2-width chi-squared float32", svm,
                        port.DataSet(X, y, dtype=np.float32),
                        port.DataSet(X_test, y_test, dtype=np.float32), y_test)
    blocks = -(-X.shape[0] // COMPACT_ROW_BLOCK)
    sym, rect = run["fit_counts"]["N"]
    log("compact", f"(b) histograms made in {made_s:.2f} s, gamma {gamma:.6f}, Bayes-optimal "
        f"accuracy {bayes:.4f}; kernel N: {sym} symmetric launch (K_mm), {rect} rect launches "
        f"(gate >= {blocks}: one a row block), plain calls {run['fit_counts']['N_plain']}; "
        f"predict through H: {run['counts']}; accuracy {run['accuracy']:.4f} (floor "
        f"{CHI2_ACCURACY_FLOOR})")
    if sym != 1 or rect < blocks or run["fit_counts"]["N_plain"] or run["accuracy"] \
            < CHI2_ACCURACY_FLOOR:
        raise AssertionError(f"compact (b): N {sym}, {rect}, accuracy {run['accuracy']}")
    launches["kernel_matrix_sym"], launches["kernel_matrix_rect"] = sym, rect
    # N's row block at the cell's shape against its plain version (not counted)
    Z = torch.as_tensor(X[run["idx"]], dtype=torch.float32, device="cuda")
    Xb = torch.as_tensor(X[:COMPACT_ROW_BLOCK], dtype=torch.float32, device="cuda")
    kw = dict(kind=K.CHI_SQUARED, gamma=gamma)
    err, scale = _check_close(f"kernel_matrix_rect chi-squared {COMPACT_ROW_BLOCK}x{COMPACT_M}"
                              f"x{X.shape[1]}", kernel_matrix.kernel_matrix_rect(Xb, Z, **kw),
                              kernel_matrix.kernel_matrix_rect_plain(Xb, Z, **kw))
    log("compact", f"(b) kernel N's rect walk at the row block {COMPACT_ROW_BLOCK}x{COMPACT_M}"
        f"x{X.shape[1]} against its plain version: max|err| {err:.3e} (max|plain| {scale:.3f}, "
        f"tolerance {F32_TOL} of it)")
    del X, y, X_test, y_test, Z, Xb

    # (c) pruning through the CLI: config 2 (binary) and the 10 classes
    (train_file, _), (test_file, test_labels) = config2_files
    mc_train, mc_test = mc_files["mc_train"][0], mc_files["mc_test"][0]
    for label, files, labels, exact_s, key in (
            ("binary", (train_file, test_file), test_labels, 0.9220, "A"),
            ("10 classes one-vs-all", (mc_train, mc_test), mc_files["mc_test"][1], 0.8535,
             "C")):
        run = _compact_cli(tmp, f"max-sv {label}", *files, labels,
                           ["--max_sv", str(COMPACT_MAX_SV)])
        its = run["its"]
        products = sum(1 + it + it // 50 for it in its) + len(its) - 1
        model = port.Model.load(os.path.join(
            tmp, f"compact-max-sv-{label.replace(' ', '-')}.model"), dtype=np.float32)
        log("compact", f"(c) --max_sv {COMPACT_MAX_SV} {label} (CLI): {len(its)} fits "
            f"({len(its) - 1} pruning rounds), iterations {its}, fit {run['fit_s']:.3f} s "
            f"(file I/O {run['io']['fit_parse']:.3f}), predict {run['predict_s']:.3f} s, "
            f"{model.num_support_vectors} SVs, accuracy {run['accuracy']:.4f} (logged; the "
            f"exact fit {exact_s}); launches {run['counts']} ({key}: {products} products)")
        if run["counts"][key] != products or run["counts"]["ffma"] or run["counts"]["plain"] \
                or model.num_support_vectors != COMPACT_MAX_SV \
                or not np.all(np.isfinite(np.asarray(model.alpha))):
            raise AssertionError(f"compact (c) {label}: {run['counts']}, "
                                 f"{model.num_support_vectors} SVs")
        launches["gram_matvec_sym_tc" if key == "A" else "gram_matmat_sym_tc"] = \
            run["counts"][key]

    # (d) streamed from the 10-class CLI files, against the in-memory fits
    train_labels = mc_files["mc_train"][1]
    train = port.DataSet(mc_train, dtype=np.float32)
    test = port.DataSet(mc_test, dtype=np.float32)
    svm = port.CSVM(backend="cuda", device="cuda", dtype=np.float32, kernel_type="rbf")
    for label, flags in (("10 classes", []),
                         ("one-class", ["-s", "one_class", "-n", str(COMPACT_NU)])):
        from plssvm_tpu_torch.cli import train as train_cli
        from plssvm_tpu_torch.native import loader

        model_file = os.path.join(tmp, f"compact-stream-{label.replace(' ', '-')}.model")
        _reset_launch_counts()
        loader.reset_counts()
        t0 = time.perf_counter()
        rc = train_cli.main(["-b", "cuda", "-p", "gpu", "-q", "-t", "2", "--nystroem",
                             str(COMPACT_CLI_M), "--streaming"] + flags + [mc_train, model_file])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = _launch_counts()
        if rc != 0:
            raise AssertionError(f"compact (d) {label}: train rc {rc}")
        native = (loader.native_parses, loader.native_writes)
        streamed = port.Model.load(model_file, dtype=np.float32)
        if flags:
            memory, idx = port.nystroem_fit_one_class(
                svm, port.DataSet(train.data), n_landmarks=COMPACT_CLI_M, nu=COMPACT_NU,
                return_indices=True)
            drawn = np.sort(np.random.default_rng(0).choice(len(train_labels), COMPACT_CLI_M,
                                                             replace=False))
        else:
            memory, idx = port.nystroem_fit(svm, train, n_landmarks=COMPACT_CLI_M,
                                            return_indices=True)
            drawn = _stratified_landmarks(train_labels, len(train_labels), COMPACT_CLI_M,
                                          np.random.default_rng(0))
        same = bool(np.array_equal(drawn, idx) and np.array_equal(
            _lexsorted(streamed.support_vectors), _lexsorted(train.data[idx])))
        f_stream = svm.predict_values(streamed, test)
        f_memory = svm.predict_values(memory, test)
        rel = float(np.max(np.abs(f_stream - f_memory)) / np.max(np.abs(f_memory)))
        log("compact", f"(d) --nystroem {COMPACT_CLI_M} --streaming {label} (CLI): fit "
            f"{fit_s:.3f} s, native parses / writes {native} (the metadata parse, the landmark "
            f"rows, each window, the model); the in-memory fit's landmarks {same}, "
            f"decision values max|d f| / max|f| {rel:.2e} (gate {COMPACT_STREAM_TOL}); launches "
            f"{counts}")
        if not same or rel > COMPACT_STREAM_TOL or counts["ffma"] or counts["plain"]:
            raise AssertionError(f"compact (d) {label}: landmarks {same}, rel {rel}")
    return launches


def _solver_taken():
    """The solver the last fit resolved ``automatic`` to (its tracker
    entry), or a note where the fit recorded none (the batched pairs solve,
    a direct solve)."""
    import plssvm_tpu_torch as port

    solvers = [v for k, v in port.global_tracker.entries().get("cg", []) if k == "solver"]
    return ", ".join(sorted(set(solvers))) or "no solver entry: batched pairs or direct"


def _facade_check(label, facade_labels, csvm_labels):
    """The facade's predicted labels (or +-1) against the CSVM-level call's
    on the same data: equal on every point."""
    equal = bool(np.array_equal(np.asarray(facade_labels), np.asarray(csvm_labels)))
    log("sklearn", f"{label}: predictions equal to the CSVM-level call's on all "
        f"{len(csvm_labels)} points {equal}")
    if not equal:
        raise AssertionError(f"sklearn {label}: predictions differ")


def phase_sklearn(mc_files, mnist_cell):
    """The sklearn facades (ROADMAP Queue 1 item 8, sklearn.py) on the card,
    float64 (their default: the DMMA tiles and the DMMA walk of O), each
    against the CSVM-level call on the same data (gate: the same labels on
    every point; values logged beside, the sigmoids' gated within
    FACADE_REL, SVR's R^2 within FRIEDMAN_R2_GAP); sklearn is not imported:

    (a) ``SVC`` on the 10-class CLI data (10000 x 200): one-vs-all (C, D);
        ``classification="oao"`` (O) with ``decision_function_shape`` "ovr"
        and "ovo"; ``probability=True`` (five folds);
    (b) ``SVR`` on Friedman #1 (oao phase (f)'s shape, 10000 x 10);
    (c) ``OneClassSVM`` at nu = COMPACT_NU on the one-class phase's
        inliers (the MNIST-width rows), its default gamma="scale";
    (d) ``SVC(max_sv=COMPACT_MAX_SV)`` and ``SVC(n_landmarks=COMPACT_CLI_M)``
        on (a)'s data.

    Returns the launches of the counted runs."""
    import plssvm_tpu_torch as port
    from plssvm_tpu_torch import oao as port_oao
    from plssvm_tpu_torch.sklearn import SVC, SVR, OneClassSVM

    launches = {}
    train = port.DataSet(mc_files["mc_train"][0], dtype=np.float64)
    test = port.DataSet(mc_files["mc_test"][0], dtype=np.float64)
    X, y, X_test = train.data, np.asarray(train.labels), test.data
    t64 = port.DataSet(X_test)

    def csvm(**params):
        return port.CSVM(backend="cuda", device="cuda", dtype=np.float64, **params)

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # (a) SVC
    for label, kw in (("one-vs-all", {}), ("one-vs-one", dict(classification="oao"))):
        _reset_launch_counts()
        port.global_tracker.clear()
        clf, fit_s = timed(lambda: SVC(kernel="rbf", tol=EPSILON, **kw).fit(X, y))
        counts = _launch_counts()
        solver = _solver_taken()
        predicted = clf.predict(X_test)
        predict_counts = _launch_counts()
        svm = csvm(kernel_type="rbf")
        model = svm.fit(port.DataSet(X, y), epsilon=EPSILON,
                        classification=kw.get("classification", "oaa"))
        _facade_check(f"(a) SVC {label}", predicted, svm.predict(model, t64))
        values = svm.predict_values(model, t64)
        shapes = {}
        for shape in (("ovr", "ovo") if kw else ("ovr",)):
            clf.set_params(decision_function_shape=shape)
            got = clf.decision_function(X_test)
            want = (port_oao.ovr_from_ovo(values, 10) if kw and shape == "ovr" else values)
            shapes[shape] = (got.shape, float(np.max(np.abs(got - want))),
                             bool(np.array_equal(got, want)))
        accuracy = float(np.mean(predicted == mc_files["mc_test"][1]))
        log("sklearn", f"(a) SVC {label}: fit {fit_s:.3f} s ({solver}), n_iter_ "
            f"{clf.n_iter_[:5]}..., accuracy {accuracy:.4f}, decision_function (shape, max|d|, "
            f"bit for bit) against the CSVM's values {shapes}; launches in the facade's fit "
            f"{counts}, after its predict {predict_counts}")
        if accuracy < MC_ACCURACY_FLOOR:
            raise AssertionError(f"sklearn (a) {label}: accuracy {accuracy}")
        # one-vs-all under automatic: C, or the explicit solver's Gram build
        # (cuBLAS) and K @ V; one-vs-one: the batched pairs solve on O; the
        # predict on D
        key = "O" if kw else "C"
        if (counts[key] <= 0 and not (solver == "cg_explicit" and key == "C")) \
                or predict_counts["D"] - counts["D"] != 1 or predict_counts["ffma"] \
                or predict_counts["plain"]:
            raise AssertionError(f"sklearn (a) {label}: launches {predict_counts}")
        launches["pairs_matvec_dmma" if kw else "gram_matmat_rect_dmma"] = \
            counts["O"] if kw else predict_counts["D"]
    _reset_launch_counts()
    clf, fit_s = timed(lambda: SVC(kernel="rbf", tol=EPSILON, probability=True,
                                   random_state=0).fit(X, y))
    counts = _launch_counts()
    proba = clf.predict_proba(X_test)
    svm = csvm(kernel_type="rbf")
    model = svm.fit(port.DataSet(X, y), epsilon=EPSILON)
    prob_a, prob_b = port.calibrate_model(svm, model, port.DataSet(X, y), epsilon=EPSILON,
                                          random_state=0)
    d_ab = float(max(np.max(np.abs(clf.probA_ - prob_a)), np.max(np.abs(clf.probB_ - prob_b)))
                 / max(np.max(np.abs(prob_a)), np.max(np.abs(prob_b))))
    log("sklearn", f"(a) SVC probability=True: fit and calibration {fit_s:.3f} s, rows sum to "
        f"1 within {float(np.max(np.abs(proba.sum(axis=1) - 1))):.1e}, max|d (A, B)| / "
        f"max|(A, B)| against calibrate_model {d_ab:.2e} (gate {FACADE_REL}); launches {counts}")
    _facade_check("(a) SVC probability=True", clf.predict(X_test), svm.predict(model, t64))
    if float(np.max(np.abs(proba.sum(axis=1) - 1))) > PROB_ROW_SUM or d_ab > FACADE_REL:
        raise AssertionError(f"sklearn (a) probability: (A, B) {d_ab}")

    # (d) the compact facades
    for label, kw, fit in (
            (f"max_sv={COMPACT_MAX_SV}", dict(max_sv=COMPACT_MAX_SV),
             lambda svm, data: port.pruned_fit(svm, data, n_sv=COMPACT_MAX_SV,
                                               epsilon=EPSILON)),
            (f"n_landmarks={COMPACT_CLI_M}", dict(n_landmarks=COMPACT_CLI_M),
             lambda svm, data: port.nystroem_fit(svm, data, n_landmarks=COMPACT_CLI_M))):
        _reset_launch_counts()
        port.global_tracker.clear()
        clf, fit_s = timed(lambda: SVC(kernel="rbf", tol=EPSILON, **kw).fit(X, y))
        counts = _launch_counts()
        solver = _solver_taken()
        svm = csvm(kernel_type="rbf")
        model = fit(svm, port.DataSet(X, y))
        log("sklearn", f"(d) SVC({label}): fit {fit_s:.3f} s ({solver}), {len(clf.support_)} SVs, "
            f"accuracy {float(np.mean(clf.predict(X_test) == mc_files['mc_test'][1])):.4f}; "
            f"launches {counts}")
        _facade_check(f"(d) SVC({label})", clf.predict(X_test), svm.predict(model, t64))

    # (b) SVR on Friedman #1
    rng = np.random.default_rng(SEED + 70)
    Xf, yf = _friedman1(rng, FRIEDMAN_N + FRIEDMAN_TEST)
    _reset_launch_counts()
    port.global_tracker.clear()
    reg, fit_s = timed(lambda: SVR(kernel="rbf", C=10.0, tol=FRIEDMAN_EPSILON).fit(
        Xf[:FRIEDMAN_N], yf[:FRIEDMAN_N]))
    counts = _launch_counts()
    solver = _solver_taken()
    svm = csvm(kernel_type="rbf", cost=10.0)
    model = svm.fit(port.DataSet(Xf[:FRIEDMAN_N], yf[:FRIEDMAN_N], regression=True),
                    epsilon=FRIEDMAN_EPSILON)
    got = reg.predict(Xf[FRIEDMAN_N:])
    want = svm.predict(model, port.DataSet(Xf[FRIEDMAN_N:]))
    d = float(np.max(np.abs(got - want)))
    r2 = (reg.score(Xf[FRIEDMAN_N:], yf[FRIEDMAN_N:]),
          svm.score(model, port.DataSet(Xf[FRIEDMAN_N:], yf[FRIEDMAN_N:], regression=True)))
    log("sklearn", f"(b) SVR Friedman #1 {FRIEDMAN_N}x{FRIEDMAN_D}: fit {fit_s:.3f} s "
        f"({solver}, {int(reg.n_iter_[0])} iterations; the CSVM-level fit {model.n_iter}), "
        f"R^2 {r2[0]:.4f} (the CSVM-level fit {r2[1]:.4f}, gate within FRIEDMAN_R2_GAP "
        f"{FRIEDMAN_R2_GAP}), values bit for bit the CSVM's {bool(np.array_equal(got, want))}, "
        f"max|d| {d:.2e} of max|y| {float(np.max(np.abs(yf))):.2f} (two float64 CG solves at "
        f"epsilon {FRIEDMAN_EPSILON}, their products summed by atomics); launches {counts}")
    if abs(r2[0] - r2[1]) > FRIEDMAN_R2_GAP or counts["A"] <= 0:
        raise AssertionError(f"sklearn (b): R^2 {r2}, launches {counts}")
    launches["gram_matvec_sym_dmma"] = counts["A"]

    # (c) OneClassSVM on the MNIST-width inliers
    inliers, held_out = mnist_cell["make"](np.float64)
    _reset_launch_counts()
    port.global_tracker.clear()
    det, fit_s = timed(lambda: OneClassSVM(nu=COMPACT_NU, tol=EPSILON).fit(inliers.data))
    counts = _launch_counts()
    solver = _solver_taken()
    gamma = 1.0 / (inliers.num_features * float(inliers.data.var()))
    svm = csvm(kernel_type="rbf", gamma=gamma)
    model = port.fit_one_class(svm, port.DataSet(inliers.data), nu=COMPACT_NU, epsilon=EPSILON)
    points = port.DataSet(held_out.data)
    _facade_check("(c) OneClassSVM", det.predict(held_out.data), svm.predict(model, points))
    share = float(np.mean(det.predict(inliers.data) == -1))
    log("sklearn", f"(c) OneClassSVM nu {COMPACT_NU} on {inliers.num_data_points} MNIST-width "
        f"rows: fit {fit_s:.3f} s ({solver}, {det.n_iter_} iterations), training share flagged "
        f"{share:.4f}, held-out inliers flagged {float(np.mean(det.predict(held_out.data) == -1)):.4f}; "
        f"launches {counts}")
    if abs(share - COMPACT_NU) > 2.0 / inliers.num_data_points:
        raise AssertionError(f"sklearn (c): training share {share}")
    absent = "sklearn" not in sys.modules
    log("sklearn", f"sklearn imported: {not absent} (the facades never import it)")
    if not absent:
        raise AssertionError("sklearn (the package) was imported by the facades")
    return launches


#: the multihost phase (ROADMAP Queue 1 item 10): gloo ranks on cuda:0 (NCCL
#: puts no two ranks on one card), the job's time limit in seconds (a hung
#: or failed rank fails the phase), and W = 4's cell's ranks
MULTIHOST_TIMEOUT = 420
MULTIHOST_W4 = 4


def _mh_launches(record, key="launches"):
    """A rank's launches of one task by counter (``gram_matmat.sym_tc_launches``
    ...), its calls of the plain versions, and its launches on the FFMA
    Gram tiles (on no path): a multi-process run leaves both at 0."""
    got = record.get(key, {})
    plain = sum(v for k, v in got.items() if k.endswith("_calls"))
    ffma = sum(got.get(f"{m}.{w}_launches", 0) for m in ("gram_matvec", "gram_matmat")
               for w in ("sym", "rect", "dual"))
    return got, plain, ffma


def _mh_check(label, records, task, want, predict_want=None):
    """Every rank's launches of ``task``: each counter of ``want`` (a
    dict) exactly, nothing on the plain versions or the FFMA tiles; the
    predict's (``predict_want``) likewise."""
    for rank, rec in enumerate(records):
        entry = next(t for t in rec["tasks"] if t["name"] == task)
        for key, wanted in ((("launches"), want), ("predict_launches", predict_want)):
            if wanted is None:
                continue
            got, plain, ffma = _mh_launches(entry, key)
            bad = {k: got.get(k, 0) for k, v in wanted.items() if got.get(k, 0) != v}
            if bad or plain or ffma:
                raise AssertionError(f"multihost {label} rank {rank} {key}: {got}, want {wanted} "
                                     f"(differ {bad}), plain calls {plain}, FFMA {ffma}")


def _mh_task(records, name, rank=0):
    return next(t for t in records[rank]["tasks"] if t["name"] == name)


def _mh_run(label, world, tasks, out):
    """Launch ``tasks`` on ``world`` gloo ranks on cuda:0; logs the ranks'
    start-up and returns their records."""
    from plssvm_tpu_torch.tools import multihost_rehearsal as rehearsal

    start = time.perf_counter()
    records = rehearsal.launch({"tasks": tasks}, world, out, device="cuda:0", backend="gloo",
                               timeout=MULTIHOST_TIMEOUT)
    wall = time.perf_counter() - start
    startup = [r["startup_s"] for r in records]
    jax_seen = [r["jax_imported"] or r["plssvm_tpu_imported"] for r in records]
    log("multihost", f"{label}: {world} gloo ranks on cuda:0, the job {wall:.1f} s, start-up "
        f"(launch to first task: interpreter, torch, process group, CUDA context) "
        f"{min(startup):.2f}-{max(startup):.2f} s, jax or plssvm_tpu imported {any(jax_seen)}")
    if any(jax_seen):
        raise AssertionError(f"multihost {label}: a rank imported jax or plssvm_tpu")
    return records


def _mh_agreement(label, got, want, need):
    agree = float(np.mean(np.asarray(got) == np.asarray(want)))
    if agree < need:
        raise AssertionError(f"multihost {label}: label agreement {agree} below {need}")
    return agree


def _mh_iterations(records, task):
    """The iterations of a fit task (rank 0's tracker; every rank ran them)."""
    return int(_mh_task(records, task)["cg.iterations"])


def _mh_solve_log(records, task, iterations):
    """Per rank: s/iteration of the solve alone, the setup (windows'
    parse, placement, the solver's choice, a build) and the bytes staged
    through pinned host memory for gloo."""
    parts = []
    for rank in range(len(records)):
        t = _mh_task(records, task, rank)
        parts.append(f"rank {rank} {t['multihost.solve_ms'] / 1000 / max(iterations, 1):.4f} s/it, "
                     f"setup {t['multihost.setup_ms'] / 1000:.2f} s, staged "
                     f"{t['staged_bytes'] / 1e9:.3f} GB")
    return "; ".join(parts)


def _mh_ring(cell_params, dtype, world, train, test, epsilon, solver="cg_implicit", **fit_kw):
    """The in-process ring over ``world`` shards of cuda:0 on the same
    files: (predicted labels, iterations, s/iteration)."""
    import plssvm_tpu_torch as port

    svm = port.CSVM(backend="cuda", devices=["cuda:0"] * world, dtype=dtype, cost=1.0,
                    solver=solver, **cell_params)
    port.global_tracker.clear()
    model = svm.fit(port.DataSet(train, dtype=dtype, **fit_kw), epsilon=epsilon)
    torch.cuda.synchronize()
    iterations = _tracked("cg", "iterations")
    s_per_it = _tracked("cg", "total_runtime") / 1000 / max(iterations, 1)
    return svm.predict(model, port.DataSet(test, dtype=dtype, **fit_kw)), iterations, s_per_it


def phase_multihost(tmp, config2_files, mnist_cell, chi2_cell):
    """Multi-process training and predict on ``torch.distributed``
    (ROADMAP Queue 1 item 10) on the one card.  NCCL refuses two ranks on
    one card, so W > 1 runs gloo with every rank on cuda:0, its tensors
    staged through pinned host memory; the ranks are processes of
    ``plssvm_tpu_torch.tools.multihost_rehearsal`` with torchrun's
    environment, each parsing its window of the files written here:

    (a) W = 4: the MNIST-width one-vs-all cell (60000 x 784, 10 classes,
        RBF, 15000 rows a rank) in float32 ("f32") and float64, beside the
        in-process ring ``CSVM(devices=["cuda:0"] * 4)`` on the same file:
        label agreement >= 0.995 (f32) / 0.999 (f64), per rank and product
        one C, one K dual and one D rows-only launch, D once to predict;
    (b) W = 3: the config 3 RBF binary cell through ``plssvm-torch-train
        --multihost`` and ``plssvm-torch-predict --multihost`` (A and J, no
        rows-only step at odd W; B to predict; rank 0 alone writes), and
        config 2's files with the laplacian (E, L, F), each beside the
        in-process ring of 3 shards;
    (c) W = 2: the histogram classes with chi-squared through
        ``automatic`` (the explicit solver: kernel N's rect walk, one
        column block per rank, then H to predict), one-class at config 3's
        width (A and the rows-only B), and Nystroem with m = COMPACT_M at
        MNIST width, each beside the in-process ring of 2 shards;
    (d) W = 1 on NCCL in this process: config 2's binary fit, its labels
        equal to ``CSVM.fit``'s.

    Four processes on one card share it: their s/iteration says nothing
    about four cards.  Nothing is caught: a failed or hung rank fails the
    phase.  Returns (the phase's launches by the kernels line's keys, the
    [cost] counts)."""
    import plssvm_tpu_torch as port
    from plssvm_tpu_torch.tools import multihost_rehearsal as rehearsal

    out = os.path.join(tmp, "multihost")
    mh_launches, cost = {}, {}

    # the files: MNIST width and config 3 RBF, written once
    start = time.perf_counter()
    mnist_train, mnist_test = (os.path.join(tmp, f"mh_mnist_{s}.libsvm") for s in ("train", "test"))
    train64, test64 = mnist_cell["make"](np.float64)
    train64.save(mnist_train)
    test64.save(mnist_test)
    c3 = _config3_rbf_cell()
    c3_train, c3_test = (os.path.join(tmp, f"mh_c3_{s}.libsvm") for s in ("train", "test"))
    for data, path in zip(c3["make"](np.float64), (c3_train, c3_test)):
        data.save(path)
    del train64, test64
    log("multihost", f"wrote the MNIST-width (60000 + 10000 x 784) and config 3 RBF "
        f"(50000 + 2000 x 500) LIBSVM files in {time.perf_counter() - start:.1f} s")
    cuda = dict(backend="cuda", device="cuda:0", cost=1.0, solver="cg_implicit")
    mc_labels = mnist_cell["labels"]

    # (a) W = 4, MNIST width, float32 and float64
    tasks = [dict(name=f"a_{t}", op="fit", file=mnist_train, predict=mnist_test,
                  csvm=dict(cuda, dtype=t, kernel_type="rbf"), fit=dict(epsilon=EPSILON))
             for t in ("float32", "float64")]
    records = _mh_run("(a) MNIST width one-vs-all", MULTIHOST_W4, tasks,
                      os.path.join(out, "a"))
    for t, dtype, need, tiles in (("float32", np.float32, 0.995, "tc"),
                                  ("float64", np.float64, 0.999, "dmma")):
        name = f"a_{t}"
        iterations = _mh_iterations(records, name)
        products = 1 + iterations + iterations // 50
        _mh_check(f"(a) {t}", records, name,
                  {f"gram_matmat.sym_{tiles}_launches": products,
                   f"gram_matmat.dual_{tiles}_launches": products,
                   f"gram_matmat.rect_{tiles}_launches": products},
                  {f"gram_matmat.rect_{tiles}_launches": 1})
        predicted = [rehearsal.load_arrays(os.path.join(out, "a"), name, r)["predictions"]
                     for r in range(MULTIHOST_W4)]
        if not all(np.array_equal(p, predicted[0]) for p in predicted):
            raise AssertionError(f"multihost (a) {t}: the ranks' predictions differ")
        ring, ring_it, ring_s = _mh_ring(dict(kernel_type="rbf"), dtype, MULTIHOST_W4,
                                         mnist_train, mnist_test, EPSILON)
        agree = _mh_agreement(f"(a) {t}", predicted[0], ring, need)
        accuracy = float(np.mean(predicted[0] == mc_labels))
        log("multihost", f"(a) MNIST width {t}, {MULTIHOST_W4} ranks: {iterations} block-CG "
            f"iterations (in-process ring {ring_it} at {ring_s:.4f} s/it); "
            f"{_mh_solve_log(records, name, iterations)} (4 processes share one card: says "
            f"nothing of four cards); accuracy {accuracy:.4f}, label agreement with the "
            f"in-process ring {agree:.4f} (gate {need}); per rank {products} C, K dual, D "
            f"rows-only launches ({tiles}), D once to predict "
            f"({_mh_task(records, name)['predict_seconds']:.2f} s)")
        if accuracy < MC_ACCURACY_FLOOR:
            raise AssertionError(f"multihost (a) {t}: accuracy {accuracy}")
        total = products * MULTIHOST_W4
        if tiles == "tc":
            mh_launches.update({("gram_matmat_sym_tc", "tf32"): total,
                                ("gram_matmat_dual", "tf32"): total,
                                ("gram_matmat_rect_tc", "tf32"): total + MULTIHOST_W4})
            cost["gram_matmat_dual"] = total
        else:
            mh_launches.update({("gram_matmat_sym_dmma", "f64"): total,
                                ("gram_matmat_dual_dmma", "f64"): total,
                                ("gram_matmat_rect_dmma", "f64"): total + MULTIHOST_W4})
            cost["gram_matmat_dual_f64"] = total

    # (b) W = 3: config 3 RBF through the CLIs; laplacian on config 2
    c3_model, c3_out = os.path.join(tmp, "mh_c3.model"), os.path.join(tmp, "mh_c3.predict")
    train2, test2 = config2_files[0][0], config2_files[1][0]
    tasks = [
        dict(name="b_train", op="cli_train",
             argv=["--multihost", "-b", "cuda", "-t", "2", "-c", "1", "-e", str(EPSILON),
                   "--solver", "cg_implicit", "-q", c3_train, c3_model]),
        dict(name="b_predict", op="cli_predict",
             argv=["--multihost", "-b", "cuda", "-q", c3_test, c3_model, c3_out]),
        dict(name="b_laplacian", op="fit", file=train2, predict=test2,
             csvm=dict(cuda, dtype="float32", kernel_type="laplacian"),
             fit=dict(epsilon=EPSILON)),
    ]
    records = _mh_run("(b) config 3 RBF CLIs, laplacian", 3, tasks, os.path.join(out, "b"))
    iterations = _mh_iterations(records, "b_train")
    products = 1 + iterations + iterations // 50
    _mh_check("(b) CLI train", records, "b_train",
              {"gram_matvec.sym_tc_launches": products, "gram_matvec.dual_tc_launches": products,
               "gram_matvec.rect_tc_launches": 0})
    _mh_check("(b) CLI predict", records, "b_predict", {"gram_matvec.rect_tc_launches": 1})
    writes = [[w for t in r["tasks"] for w in t["writes"]] for r in records]
    if writes[0] != [["model", c3_model]] or any(writes[1:]):
        raise AssertionError(f"multihost (b): files written per rank {writes}")
    predicted = np.asarray([int(line) for line in open(c3_out, encoding="utf-8")])
    ring, ring_it, ring_s = _mh_ring(dict(kernel_type="rbf"), np.float32, 3, c3_train, c3_test,
                                     EPSILON)
    agree = _mh_agreement("(b) config 3", predicted, ring, 0.995)
    accuracy = float(np.mean(predicted == c3["labels"]))
    log("multihost", f"(b) config 3 RBF through the CLIs, 3 ranks: {iterations} CG iterations "
        f"(in-process ring {ring_it} at {ring_s:.4f} s/it); fit "
        f"{_mh_task(records, 'b_train')['seconds']:.1f} s and predict "
        f"{_mh_task(records, 'b_predict')['seconds']:.1f} s a rank (file I/O included); "
        f"accuracy {accuracy:.4f}, agreement with the in-process ring {agree:.4f}; per rank "
        f"{products} A and J launches, no rows-only B, B once to predict; rank 0 alone wrote "
        f"the model")
    if accuracy < ACCURACY_FLOOR:
        raise AssertionError(f"multihost (b): accuracy {accuracy}")
    iterations = _mh_iterations(records, "b_laplacian")
    lap_products = 1 + iterations + iterations // 50
    _mh_check("(b) laplacian", records, "b_laplacian",
              {"distance.matvec_sym_launches": lap_products,
               "distance.matvec_dual_launches": lap_products,
               "distance.matvec_rect_launches": 0}, {"distance.matvec_rect_launches": 1})
    predicted = rehearsal.load_arrays(os.path.join(out, "b"), "b_laplacian", 0)["predictions"]
    ring, ring_it, ring_s = _mh_ring(dict(kernel_type="laplacian"), np.float32, 3, train2,
                                     test2, EPSILON)
    agree = _mh_agreement("(b) laplacian", predicted, ring, 0.995)
    accuracy = float(np.mean(predicted == config2_files[1][1]))
    log("multihost", f"(b) laplacian on config 2's files, 3 ranks: {iterations} CG iterations "
        f"(in-process ring {ring_it} at {ring_s:.4f} s/it); "
        f"{_mh_solve_log(records, 'b_laplacian', iterations)}; accuracy {accuracy:.4f}, "
        f"agreement with the in-process ring {agree:.4f}; per rank {lap_products} E and L "
        f"launches, F once to predict")
    if accuracy < LAPLACIAN_ACCURACY_FLOOR:
        raise AssertionError(f"multihost (b) laplacian: accuracy {accuracy}")
    mh_launches.update({("gram_matvec_sym_tc", "tf32"): 3 * products,
                        ("gram_matvec_dual", "tf32"): 3 * products,
                        ("gram_matvec_rect_tc", "tf32"): 3,
                        ("distance_matvec_sym", "laplacian"): 3 * lap_products,
                        ("distance_matvec_dual", "laplacian"): 3 * lap_products,
                        ("distance_matvec_rect", "laplacian"): 3})
    cost["gram_matvec_dual"] = 3 * products
    cost["distance_matvec_dual"] = 3 * lap_products

    # (c) W = 2: chi-squared through automatic, one-class, Nystroem
    chi2_train = os.path.join(tmp, "chi2_train.libsvm")
    chi2_test = os.path.join(tmp, "chi2_test.libsvm")
    chi2_params = chi2_cell["params"]
    tasks = [
        dict(name="c_chi2", op="fit", file=chi2_train, predict=chi2_test,
             csvm=dict(cuda, dtype="float32", solver="automatic", **chi2_params),
             fit=dict(epsilon=chi2_cell["epsilon"])),
        dict(name="c_one_class", op="one_class", file=c3_train, predict=c3_test,
             csvm=dict(cuda, dtype="float32", kernel_type="rbf"),
             fit=dict(nu=ONE_CLASS_NU, epsilon=EPSILON)),
        dict(name="c_nystroem", op="nystroem", file=mnist_train, predict=mnist_test,
             csvm=dict(cuda, dtype="float32", kernel_type="rbf"),
             fit=dict(n_landmarks=COMPACT_M, row_block=COMPACT_ROW_BLOCK)),
    ]
    records = _mh_run("(c) chi-squared, one-class, Nystroem", 2, tasks, os.path.join(out, "c"))
    if _mh_task(records, "c_chi2")["cg.solver"] != "cg_explicit":
        raise AssertionError("multihost (c): automatic did not take the explicit solver")
    _mh_check("(c) chi-squared", records, "c_chi2",
              {"kernel_matrix.rect_launches": 2, "kernel_matrix.sym_launches": 0,
               "distance.matmat_sym_launches": 0}, {"distance.matmat_rect_launches": 1})
    iterations = _mh_iterations(records, "c_chi2")
    predicted = rehearsal.load_arrays(os.path.join(out, "c"), "c_chi2", 0)["predictions"]
    ring, ring_it, ring_s = _mh_ring(chi2_params, np.float32, 2, chi2_train, chi2_test,
                                     chi2_cell["epsilon"], solver="automatic")
    agree = _mh_agreement("(c) chi-squared", predicted, ring, 0.995)
    accuracy = float(np.mean(predicted == chi2_cell["labels"]))
    log("multihost", f"(c) chi-squared histogram classes through automatic "
        f"({_mh_task(records, 'c_chi2')['cg.solver']}), 2 ranks: build "
        f"{_mh_task(records, 'c_chi2')['cg.kernel_matrix_build_time']:.1f} ms (2 column blocks "
        f"a rank on N's rect walk), {iterations} block-CG iterations (in-process ring "
        f"{ring_it} at {ring_s:.4f} s/it); {_mh_solve_log(records, 'c_chi2', iterations)}; "
        f"accuracy {accuracy:.4f}, agreement with the in-process ring {agree:.4f}")
    if accuracy < CHI2_ACCURACY_FLOOR:
        raise AssertionError(f"multihost (c) chi-squared: accuracy {accuracy}")
    oc = _mh_task(records, "c_one_class")
    oc_products = oc["n_iter"] + oc["n_iter"] // 50 + 1
    _mh_check("(c) one-class", records, "c_one_class",
              {"gram_matvec.sym_tc_launches": oc_products, "gram_matvec.dual_tc_launches": 0,
               "gram_matvec.rect_tc_launches": oc_products},
              {"gram_matvec.rect_tc_launches": 1})
    oc_predicted = rehearsal.load_arrays(os.path.join(out, "c"), "c_one_class", 0)["predictions"]
    svm = port.CSVM(backend="cuda", devices=["cuda:0"] * 2, dtype=np.float32,
                    kernel_type="rbf", cost=1.0, solver="cg_implicit")
    one_class = port.fit_one_class(svm, port.DataSet(c3_train, dtype=np.float32),
                                   nu=ONE_CLASS_NU, epsilon=EPSILON)
    oc_ring = svm.predict(one_class, port.DataSet(c3_test, dtype=np.float32))
    oc_agree = _mh_agreement("(c) one-class", oc_predicted, oc_ring, ONE_CLASS_AGREEMENT)
    ny_predicted = rehearsal.load_arrays(os.path.join(out, "c"), "c_nystroem", 0)["predictions"]
    svm = port.CSVM(backend="cuda", devices=["cuda:0"] * 2, dtype=np.float32,
                    kernel_type="rbf", cost=1.0)
    nystroem = port.nystroem_fit(svm, port.DataSet(mnist_train, dtype=np.float32),
                                 n_landmarks=COMPACT_M, row_block=COMPACT_ROW_BLOCK)
    ny_ring = svm.predict(nystroem, port.DataSet(mnist_test, dtype=np.float32))
    ny_agree = _mh_agreement("(c) Nystroem", ny_predicted, ny_ring, 0.995)
    ny_accuracy = float(np.mean(ny_predicted == mc_labels))
    log("multihost", f"(c) one-class at config 3's width, 2 ranks: {oc['n_iter']} ridge-CG "
        f"iterations ({one_class.n_iter} in-process), {oc['seconds']:.1f} s a rank, sign "
        f"agreement on the held-out points with the in-process ring {oc_agree:.4f}; per rank "
        f"{oc_products} A and rows-only B launches (the scores' product included), no J; "
        f"Nystroem m = {COMPACT_M} at MNIST width: {_mh_task(records, 'c_nystroem')['seconds']:.1f} "
        f"s a rank, accuracy {ny_accuracy:.4f}, agreement with the in-process reduction "
        f"{ny_agree:.4f}")
    if ny_accuracy < MC_ACCURACY_FLOOR:
        raise AssertionError(f"multihost (c) Nystroem: accuracy {ny_accuracy}")
    mh_launches.update({("kernel_matrix_rect", "chi_squared"): 4,
                        ("distance_matmat_rect", "chi_squared"): 2})
    mh_launches[("gram_matvec_sym_tc", "tf32")] += 2 * oc_products
    mh_launches[("gram_matvec_rect_tc", "tf32")] += 2 * oc_products + 2

    # (d) W = 1 on NCCL, in this process
    import torch.distributed as dist
    from plssvm_tpu_torch.ops import gram_matvec
    from plssvm_tpu_torch.parallel import multihost

    multihost.initialize_distributed(f"tcp://127.0.0.1:{rehearsal.free_port()}", 1, 0,
                                     backend="nccl", device="cuda:0",
                                     timeout=MULTIHOST_TIMEOUT)
    try:
        svm = port.CSVM(backend="cuda", device="cuda:0", dtype=np.float32, kernel_type="rbf",
                        solver="cg_implicit")
        test = port.DataSet(test2, dtype=np.float32)
        gram_matvec.reset_counts()
        model = svm.fit_multihost(train2, epsilon=EPSILON)
        launches = gram_matvec.sym_tc_launches
        backend = dist.get_backend()
        predicted = svm.predict(model, test)
    finally:
        dist.destroy_process_group()
    alone = svm.fit(port.DataSet(train2, dtype=np.float32), epsilon=EPSILON)
    wanted = svm.predict(alone, test)
    products = 1 + model.n_iter + model.n_iter // 50
    dvalue = float(np.max(np.abs(svm.predict_values(model, test)
                                 - svm.predict_values(alone, test))))
    log("multihost", f"(d) config 2 binary, 1 rank on {backend}: {model.n_iter} CG iterations "
        f"(CSVM.fit {alone.n_iter}), {launches} A launches, labels equal to CSVM.fit's "
        f"{bool(np.array_equal(predicted, wanted))}, max|d f(x)| {dvalue:.3e}")
    if backend != "nccl" or launches != products or not np.array_equal(predicted, wanted):
        raise AssertionError(f"multihost (d): backend {backend}, A launches {launches} "
                             f"(want {products}), labels equal {np.array_equal(predicted, wanted)}")
    return mh_launches, cost


def _determinism_calls(gen):
    """(label, zero-argument call) for every walk that sums across blocks
    (csrc/fixed_sum.cuh) at the shapes the main path gives it: A / B at
    config 2's (10000 x 200, 2000 points) and C / D with 10 classes there,
    C at MNIST's width, D against its 60000 SVs, at each float32 tier and
    in float64 (the DMMA tiles); J / K at the ring's blocks (config 3 RBF
    12500^2 x 500, MNIST 15000^2 x 784 with 10 classes) at each tier and
    in float64; E-H at config 2's files (laplacian E / F, chi-squared G /
    H) in both types, G at chi2-width; L / M at the ring's 2500^2 x 200
    blocks in both types; I at its tool's 32768 x 128; A-D and K's FFMA
    tiles (on no path) at config 2's."""
    from plssvm_tpu_torch.ops import banded, distance, gram_matmat, gram_matvec
    from plssvm_tpu_torch.parameter import KernelFunctionType as Kind

    def normal(*shape, dtype=torch.float32, scale=1.0, positive=False):
        t = torch.randn(*shape, generator=gen, dtype=torch.float64) * scale
        return (t.abs() if positive else t).to("cuda", dtype)

    calls = []

    def add(dtype, tiers):
        """This type's calls: closures over this call's tensors."""
        nonlocal calls
        label = "f32" if dtype == torch.float32 else "f64"
        X = normal(10000, 200, dtype=dtype, scale=0.3)
        P = normal(2000, 200, dtype=dtype, scale=0.3)
        sq, sq_p = (X * X).sum(-1), (P * P).sum(-1)
        v, V = normal(10000, dtype=dtype), normal(10000, 10, dtype=dtype)
        kw = dict(kind=Kind.RBF, gamma=1.0 / 200, coef0=0.0, degree=3)
        for tier in tiers:
            name = tier if dtype == torch.float32 else "f64"
            calls += [
                (f"A {name} 10000x200", lambda X=X, sq=sq, v=v, t=tier:
                 gram_matvec.gram_matvec_sym(X, sq, v, precision=t, **kw)),
                (f"B {name} 2000x10000x200", lambda P=P, X=X, sq_p=sq_p, sq=sq, v=v, t=tier:
                 gram_matvec.gram_matvec_rect(P, X, sq_p, sq, v, precision=t, **kw)),
                (f"C {name} 10000x200 C=10", lambda X=X, sq=sq, V=V, t=tier:
                 gram_matmat.gram_matmat_sym(X, sq, V, precision=t, **kw)),
                (f"D {name} 2000x10000x200 C=10", lambda P=P, X=X, sq_p=sq_p, sq=sq, V=V,
                 t=tier: gram_matmat.gram_matmat_rect(P, X, sq_p, sq, V, precision=t, **kw)),
            ]
        if dtype == torch.float32:
            calls += [
                ("A FFMA 10000x200", lambda X=X, sq=sq, v=v:
                 gram_matvec.gram_ffma("matvec_sym", (X,), (sq,), v, **kw)),
                ("B FFMA 2000x10000x200", lambda P=P, X=X, sq_p=sq_p, sq=sq, v=v:
                 gram_matvec.gram_ffma("matvec_rect", (P, X), (sq_p, sq), v, **kw)),
                ("C FFMA 10000x200 C=10", lambda X=X, sq=sq, V=V:
                 gram_matvec.gram_ffma("matmat_sym", (X,), (sq,), V, **kw)),
                ("D FFMA 2000x10000x200 C=10", lambda P=P, X=X, sq_p=sq_p, sq=sq, V=V:
                 gram_matvec.gram_ffma("matmat_rect", (P, X), (sq_p, sq), V, **kw)),
                ("K FFMA 2000x10000x200 C=10", lambda P=P, X=X, sq_p=sq_p, sq=sq, V=V:
                 gram_matvec.gram_ffma("matmat_dual", (P, X), (sq_p, sq),
                                       (V, V[:2000].contiguous()), **kw)),
            ]
        # MNIST width: C over 60000 x 784 in passes, D 10000 x 60000 x 784
        Xw = normal(60000, 784, dtype=dtype, scale=0.05)
        sqw, Vw = (Xw * Xw).sum(-1), normal(60000, 10, dtype=dtype)
        kww = dict(kw, gamma=1.0 / 784)
        calls += [
            (f"C {label} 60000x784 C=10", lambda: gram_matmat.gram_matmat_sym(
                Xw, sqw, Vw, **kww)),
            (f"D {label} 10000x60000x784 C=10", lambda: gram_matmat.gram_matmat_rect(
                Xw[:10000], Xw, sqw[:10000], sqw, Vw, **kww)),
        ]
        for mr, d, classes in ((12500, 500, None), (15000, 784, 10)):
            Xr = normal(mr, d, dtype=dtype, scale=0.05)
            Xc = normal(mr, d, dtype=dtype, scale=0.05)
            tail = () if classes is None else (classes,)
            args = (Xr, Xc, (Xr * Xr).sum(-1), (Xc * Xc).sum(-1), normal(mr, *tail, dtype=dtype),
                    normal(mr, *tail, dtype=dtype))
            fn = gram_matvec.gram_matvec_dual if classes is None else gram_matmat.gram_matmat_dual
            for tier in tiers:
                name = tier if dtype == torch.float32 else "f64"
                calls.append((f"{'J' if classes is None else 'K'} {name} {mr}^2x{d}",
                              lambda fn=fn, args=args, t=tier, d=d:
                              fn(*args, precision=t, **dict(kw, gamma=1.0 / d))))
        # the distance kinds
        H = normal(10000, 200, dtype=dtype, positive=True) / 200
        Hp = H[:2000]
        for kind, gamma in ((Kind.LAPLACIAN, 1.0 / 200), (Kind.CHI_SQUARED, 1.0)):
            kd = dict(kind=kind, gamma=gamma)
            calls += [
                (f"E {label} {kind} 10000x200", lambda kd=kd: distance.distance_matvec_sym(
                    H, v, **kd)),
                (f"F {label} {kind} 2000x10000x200", lambda kd=kd:
                 distance.distance_matvec_rect(Hp, H, v, **kd)),
                (f"G {label} {kind} 10000x200 C=10", lambda kd=kd:
                 distance.distance_matmat_sym(H, V, **kd)),
                (f"H {label} {kind} 2000x10000x200 C=10", lambda kd=kd:
                 distance.distance_matmat_rect(Hp, H, V, **kd)),
                (f"L {label} {kind} 2500^2x200", lambda kd=kd: distance.distance_matvec_dual(
                    H[:2500], H[2500:5000], v[:2500], v[2500:5000], **kd)),
                (f"M {label} {kind} 2500^2x200 C=10", lambda kd=kd:
                 distance.distance_matmat_dual(H[:2500], H[2500:5000],
                                               V[:2500].contiguous(),
                                               V[2500:5000].contiguous(), **kd)),
            ]
        XT = (normal(128, 32768, dtype=dtype, positive=True) / 128).contiguous()
        vb = normal(32768, dtype=dtype)
        for symmetric in (True, False):
            calls.append((f"I {label} 32768x128 symmetric={symmetric}",
                          lambda XT=XT, vb=vb, s=symmetric: banded.banded_matvec(
                              XT, vb, 1.0 / 128, symmetric=s)))

    add(torch.float32, ("f32", "bf16", "highest"))
    add(torch.float64, ("f32",))
    Hw = normal(60000, 784, positive=True) / 784
    Vh = normal(60000, 10)
    calls.append(("G f32 chi-squared 60000x784 C=10", lambda: distance.distance_matmat_sym(
        Hw, Vh, kind=Kind.CHI_SQUARED, gamma=1.0)))
    return calls


def _fixed_sum_entry():
    """The reduction alone (``gram_matvec.fixed_sum``) at MNIST width's
    kernel C: 469 slots (its column tiles) of 60000 x 10 float32 partials,
    against its plain version (the same slot order: the same bits), beside
    ``torch.sum`` over the slots (library_ms) and the bound (the slots read
    once, the output read and written once, at 3.35 TB/s)."""
    from plssvm_tpu_torch.ops import gram_matvec, matvec

    slots, n = 469, 60000 * 10
    gen = torch.Generator(device="cuda").manual_seed(SEED + 25)
    ws = torch.randn(slots, n, generator=gen, device="cuda")
    out = torch.zeros(n, device="cuda")
    got = gram_matvec.fixed_sum(ws, out.clone())
    want = matvec.fixed_sum_plain(ws, out)
    err = float((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"fixed_sum: max |kernel - plain| {err} (the same order: 0)")
    ms = _back_to_back_ms(lambda: gram_matvec.fixed_sum(ws, out))
    plain_ms = _median_ms(lambda: matvec.fixed_sum_plain(ws, out), repeats=5)
    library_ms = _back_to_back_ms(lambda: torch.sum(ws, dim=0))
    bound = _bound(0, 0, slots * n, "gram", (slots + 2) * n * 4)
    log("determinism", f"fixed_sum {slots} slots x {n}: {ms:.3f} ms (plain {plain_ms:.3f}, "
        f"torch.sum {library_ms:.3f}), bound {bound[0]:.3f} ms ({bound[1]}), "
        f"{bound[0] / ms:.3f} of it, max |kernel - plain| {err}")
    if ms < bound[0]:
        raise AssertionError(f"fixed_sum measured {ms} ms under its bound {bound[0]}")
    return err, (ms, plain_ms), bound, library_ms


def phase_determinism(tmp, config2_files, mnist_cell):
    """ROADMAP Queue 3 item 2 closed: every walk that sums across blocks
    (csrc/fixed_sum.cuh), called twice on the same inputs at the main
    path's shapes, gives equal bits (``_determinism_calls``); two config-2
    CLI fits write the same model file below its creation-time comment; two
    MNIST-width 10-class fits give equal alphas; and the reduction alone
    against its plain version (``_fixed_sum_entry``)."""
    import plssvm_tpu_torch as port
    from plssvm_tpu_torch.cli import train as train_cli

    start = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 26)
    calls = _determinism_calls(gen)
    for label, call in calls:
        first, second = call(), call()
        first = first if isinstance(first, tuple) else (first,)
        second = second if isinstance(second, tuple) else (second,)
        if not all(torch.equal(a, b) for a, b in zip(first, second)):
            diff = max(float((a - b).abs().max()) for a, b in zip(first, second))
            raise AssertionError(f"determinism: {label} twice differs by {diff}")
    torch.cuda.synchronize()
    log("determinism", f"{len(calls)} walks called twice at the main path's shapes: equal "
        f"bits in every one ({time.perf_counter() - start:.1f} s)")
    (train_file, _), _ = config2_files
    models = []
    for run in range(2):
        model_file = os.path.join(tmp, f"determinism{run}.model")
        if train_cli.main(["-b", "cuda", "-p", "gpu", "-q", "--solver", "cg_implicit", "-t",
                           "2", "-c", "1", "-e", str(EPSILON), train_file, model_file]) != 0:
            raise AssertionError("determinism: config 2's CLI fit failed")
        with open(model_file, "rb") as fh:
            head = fh.readline()
            if not head.startswith(b"# This model file has been created at"):
                raise AssertionError(f"determinism: model header {head!r}")
            models.append(fh.read())
    if models[0] != models[1]:
        raise AssertionError("determinism: two config-2 CLI fits wrote different models")
    log("determinism", f"two config-2 CLI fits: model files equal below the creation-time "
        f"line ({len(models[0])} bytes)")
    train, _ = mnist_cell["make"](np.float32)
    fits = []
    for _ in range(2):
        svm = port.CSVM(backend="cuda", device="cuda", dtype=np.float32, kernel_type="rbf",
                        cost=1.0, solver="cg_implicit")
        fits.append(svm.fit(train, epsilon=mnist_cell["epsilon"]))
    if fits[0].n_iter != fits[1].n_iter or not np.array_equal(fits[0].alpha, fits[1].alpha) \
            or not np.array_equal(fits[0].rho, fits[1].rho):
        raise AssertionError("determinism: two MNIST-width fits differ")
    log("determinism", f"two MNIST-width 10-class fits: {fits[0].n_iter} iterations each, "
        "alpha and rho equal bit for bit")
    return _fixed_sum_entry()


#: the tools of the port run at a small size on the card (phase ``tools``)
TOOL_RUNS = (
    ("bench_matmat", ["4096", "64", "3", "2"]),
    ("bench_distance", ["--m", "4096", "--d", "64", "--iters", "2"]),
    ("bench_solver", ["4096", "64", "4", "rbf", "f32"]),
    ("scaling_sweep", ["--n", "4096", "--d", "64", "--iters", "4", "--mesh-sizes", "1,2"]),
    ("scaling_projection", ["--devices", "2", "--m_per_dev", "128", "--d", "16"]),
    ("plssvm_target_platforms", []),
)


def phase_tools(tmp, config2_files):
    """ROADMAP item 11's tools, each at a small size on the card (their
    figures are logged, not read: the tools' own lines), the tracker's
    YAML of ``performance_analysis`` through the port's parser, and
    ``plssvm-torch-train --profile`` on config 2's CLI fit: the trace must
    name the hand kernel of that path, ``gram_tc_sym_kernel`` (kernel A on
    the tensor cores), and the model must be the one the fit without
    ``--profile`` writes."""
    import importlib

    from plssvm_tpu_torch.cli import train as train_cli

    for name, argv in TOOL_RUNS:
        tool = importlib.import_module(f"plssvm_tpu_torch.tools.{name}")
        lines = _run_tool("tools", tool.main, argv)
        if not lines:
            raise AssertionError(f"tools: {name} printed nothing")
    tracking = os.path.join(tmp, "tools.yaml")
    from plssvm_tpu_torch.tools import performance_analysis, performance_tracker_yaml_parser

    _run_tool("tools", performance_analysis.main, [
        "--num_data_points", "2000", "--num_features", "20", "--num_repeats", "2",
        "--performance_tracking", tracking,
        "--intermediate_train_file", os.path.join(tmp, "tools.libsvm")])
    docs = performance_tracker_yaml_parser.parse_tracking_file(tracking)
    if len(docs) != 2 or any("cg.iterations" not in doc for doc in docs):
        raise AssertionError(f"tools: the tracker's YAML read {len(docs)} documents")
    (train_file, _), _ = config2_files
    trace_dir = os.path.join(tmp, "profile")
    flags = ["-b", "cuda", "-p", "gpu", "-q", "--solver", "cg_implicit", "-t", "2", "-c", "1",
             "-e", str(EPSILON)]
    model = os.path.join(tmp, "profiled.model")
    start = time.perf_counter()
    if train_cli.main(flags + ["--profile", trace_dir, train_file, model]) != 0:
        raise AssertionError("tools: plssvm-torch-train --profile failed")
    seconds = time.perf_counter() - start
    traces = [f for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")]
    if len(traces) != 1:
        raise AssertionError(f"tools: --profile wrote {traces}")
    with open(os.path.join(trace_dir, traces[0]), encoding="utf-8") as fh:
        trace = json.load(fh)
    events = trace.get("traceEvents", [])
    kernels = [e for e in events if "gram_tc_sym_kernel" in str(e.get("name", ""))]
    if not kernels:
        raise AssertionError("tools: the --profile trace names no gram_tc_sym_kernel")
    device_us = sum(e.get("dur", 0) for e in kernels if e.get("cat") == "kernel")
    plain = os.path.join(tmp, "unprofiled.model")
    if train_cli.main(flags + [train_file, plain]) != 0:
        raise AssertionError("tools: config 2's fit without --profile failed")
    with open(model, "rb") as a, open(plain, "rb") as b:
        a.readline(), b.readline()
        if a.read() != b.read():
            raise AssertionError("tools: --profile changed the model")
    log("tools", f"--profile: fit {seconds:.3f} s, trace {traces[0]} with {len(events)} "
        f"events, {len(kernels)} of gram_tc_sym_kernel ({device_us / 1e3:.3f} ms on the "
        "card); the model equals the fit's without --profile")


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="Drive the port's main path on one GPU.")
    parser.add_argument("--compare-build", metavar="DIR",
                        help="another checkout whose kernels' resources the build phase "
                             "compares with these, and whose distance kernels, J at "
                             "'highest', kernel O's FFMA walk and float64 distance fits the "
                             "compare phase times beside these")
    parser.add_argument("--oao-f64-compare", metavar="DIR",
                        help="run only the device and build phases (building DIR's kernels "
                             "too) and time oao (b)'s and (e)'s float64 fits in DIR and here "
                             "(_oao_f64_times)")
    parser.add_argument("--chi2-width-agreement", action="store_true",
                        help="run only the chi2-width agreement study "
                             "(phase_chi2_width_agreement) and print its record")
    parser.add_argument("--multihost-only", action="store_true",
                        help="run only the device and build phases, the cells the "
                             "multihost phase reads (config 2's files, the chi-squared "
                             "CLI cell, MNIST width) and the multihost phase")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available.",
              file=sys.stderr)
        return 1
    import plssvm_tpu_torch

    plssvm_tpu_torch.set_verbosity("quiet")
    torch.manual_seed(SEED)
    if args.oao_f64_compare:
        _, smi = phase_device()
        phase_build(args.oao_f64_compare)
        phase_compare(args.oao_f64_compare, "_oao_f64_times")
        print(smi)
        return 0
    if args.multihost_only:
        _, smi = phase_device()
        phase_build()
        with tempfile.TemporaryDirectory() as tmp:
            start = time.perf_counter()
            config2_files = _write_config2(tmp)
            _, chi2_cell = phase_chi2_cli(tmp)
            _, mnist_cell = phase_multiclass_width()
            log("times", f"the multihost phase's cells {time.perf_counter() - start:.1f} s")
            start = time.perf_counter()
            phase_multihost(tmp, config2_files, mnist_cell, chi2_cell)
            log("times", f"multihost {time.perf_counter() - start:.1f} s")
        print(smi)
        return 0
    if args.chi2_width_agreement:
        _, smi = phase_device()
        record = phase_chi2_width_agreement()
        print(smi)
        print(json.dumps(record))
        return 0
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
        mc_written = _write_multiclass(tmp)
        run("parse", phase_parse, tmp, config2_files, mc_written)
        phase_launches["e2e"], e2e_predicted = run("e2e", phase_end_to_end, tmp,
                                                   config2_files)
        phase_launches["multiclass"], mc_files = run("multiclass", phase_multiclass_cli,
                                                     tmp, mc_written)
        phase_launches["bf16"] = run("bf16", phase_bf16, tmp, config2_files,
                                     e2e_predicted, mc_files)
        ring_cells = {}
        phase_launches["laplacian"], ring_cells["laplacian"] = run(
            "laplacian", phase_laplacian_cli, tmp, config2_files)
        phase_launches["chi2-cli"], ring_cells["chi2"] = run("chi2-cli", phase_chi2_cli, tmp)
        run("extras", phase_extras, tmp, config2_files, mc_written, ring_cells)
        run("host-clis", phase_host_clis, tmp, config2_files)
        phase_launches["config3"] = run("config3", phase_config3_width)
        phase_launches["mnist-width"], ring_cells["mnist-width"] = run(
            "mnist-width", phase_multiclass_width)
        fixed = run("determinism", phase_determinism, tmp, config2_files,
                    ring_cells["mnist-width"])
        main_err["fixed_sum"], timing["fixed_sum"], bounds["fixed_sum"] = fixed[:3]
        library = {"fixed_sum": fixed[3]}
        phase_launches["highest"] = run("highest", phase_highest, tmp, config2_files,
                                        ring_cells["mnist-width"])
        phase_launches["oao"], oao_kernels = run(
            "oao", phase_oao, tmp, mc_written, ring_cells["chi2"], ring_cells["mnist-width"],
            main_ms)
        for table, values in zip((main_err, timing, bounds), oao_kernels):
            table.update(values)
        phase_launches["chi2-width"], chi2_width = run("chi2-width", phase_chi2_width,
                                                       g_chi_ms)
        phase_launches["explicit"], explicit_kernels = run(
            "explicit", phase_explicit, tmp, config2_files, e2e_predicted, ring_cells,
            chi2_width)
        for table, values in zip((main_err, timing, bounds, main_ms), explicit_kernels):
            table.update(values)
        del chi2_width
        run("stall", phase_stall, ring_cells["chi2"])
        phase_launches.update(run("ring", phase_ring, ring_cells))
        phase_launches["one-class"] = run("one-class", phase_one_class, tmp, config2_files,
                                          ring_cells["mnist-width"])
        phase_launches["probability"] = run("probability", phase_probability, tmp,
                                            config2_files, mc_written, e2e_predicted,
                                            ring_cells["mnist-width"])
        phase_launches["robust"] = run("robust", phase_robust)
        phase_launches["compact"] = run("compact", phase_compact, tmp, config2_files,
                                        mc_written, ring_cells["mnist-width"])
        phase_launches["sklearn"] = run("sklearn", phase_sklearn, mc_written,
                                        ring_cells["mnist-width"])
        mh_launches, phase_launches["multihost"] = run(
            "multihost", phase_multihost, tmp, config2_files, ring_cells["mnist-width"],
            ring_cells["chi2"])
        run("tools", phase_tools, tmp, config2_files)
        # (a)'s K walks run at the ring phase's shards of MNIST width
        main_ms[("gram_matmat_dual", "multihost")] = main_ms[("gram_matmat_dual", "ring")]
        main_ms[("gram_matmat_dual_f64", "multihost")] = \
            main_ms[("gram_matmat_dual_f64", "ring-f64")]
        del ring_cells
    phase_launches["banded-tool"] = run("banded-tool", phase_banded_tool)
    phase_launches["bench-matvec"] = run("bench-matvec", phase_bench_matvec, main_ms)
    log("times", ", ".join(f"{k} {v:.1f} s" for k, v in phase_seconds.items()))
    # the workspaces of the fixed-order sums at every shape this run gave
    # an entry point: at most 1 GiB (csrc/fixed_sum.cuh's budget a pass)
    from plssvm_tpu_torch.ops import gram_matvec

    largest = sorted(gram_matvec.workspace_peak.items(), key=lambda kv: -kv[1])
    log("workspace", ", ".join(f"{name} {size / 2**20:.1f} MiB" for name, size in largest[:8]))
    if largest and largest[0][1] > 1 << 30:
        raise AssertionError(f"workspace: {largest[0][0]} asked for {largest[0][1]} bytes")

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
    # tensor-core tiles' "bf16" entries, the highest phase's for their
    # "tf32x3" ones, else the first other phase's
    launches = {}
    for phase, counts in phase_launches.items():
        for k, n in counts.items():
            if phase in ("bf16", "highest"):
                launches[(k, TIER_OF[phase])] = n
            elif phase != "ring-highest":
                launches.setdefault(k, n)
    # the ring-highest cells' dual walks: K on the split dual tile, J on its
    # matvec walk
    launches[("gram_matmat_dual", "tf32x3")] = phase_launches["ring-highest"]["gram_matmat_dual"]
    launches[("gram_matvec_dual", "highest")] = \
        phase_launches["ring-highest"]["gram_matvec_dual"]
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
    # kernel N's symmetric walk: an entry per type and kind the explicit
    # phase's fits built with it
    launches[("kernel_matrix_sym", "f64")] = launches["kernel_matrix_sym_f64"]
    launches[("kernel_matrix_sym", "laplacian")] = launches["kernel_matrix_sym_laplacian"]
    # float64 distance kernels: the ring's float64 fits (E-H the shard
    # products, L and M the dual walks)
    for kernel in ("distance_matvec_sym", "distance_matvec_rect", "distance_matmat_sym",
                   "distance_matmat_rect", "distance_matvec_dual", "distance_matmat_dual"):
        launches[(kernel, "f64")] = launches[f"{kernel}_f64"]

    # the distance kernels report the kind their main path ran: laplacian
    # for E and F (phase 8), chi-squared for G and H (phases 9 and 10); the
    # dual walks J-M the ring phase's launches, J and K at "f32" (TF32),
    # K on the split tile ("tf32x3") and J on its walk ("highest") the
    # ring-highest cells';
    # kernel_matvec's launches are phase 12's, kernel I's phase 11's; the
    # FFMA tiles of A and B, on no wrapper's path (``on_path`` false), the
    # count of every main-path phase, 0, beside the float32 times that
    # "highest" ran at before the split tier; the tensor-core tiles one
    # entry per tier ("tf32x3": the highest phase's); the float64 entries (tier "f64") their float64 launches
    # (A-D phases 4 and 5, J and K the ring) beside their float64 times and
    # bounds.  No single PyTorch call computes any kernel's function
    # (library_ms)
    tiers = {"gram_matvec_sym": "highest", "gram_matvec_rect": "highest",
             "kernel_matvec": "tf32", ("pairs_matvec", "rbf"): "highest"}
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
        ("gram_matvec_sym_tc", "tf32x3"): (
            "gram_tc.cuh", "plssvm_tpu/ops/pallas_matvec.py:430"),
        ("gram_matmat_sym_tc", "tf32x3"): (
            "gram_tc.cuh", "plssvm_tpu/ops/pallas_matvec.py:812"),
        ("gram_matvec_rect_tc", "tf32x3"): (
            "gram_tc.cuh", "plssvm_tpu/ops/pallas_matvec.py:1007"),
        ("gram_matmat_rect_tc", "tf32x3"): (
            "gram_tc.cuh", "plssvm_tpu/ops/pallas_matvec.py:812"),
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
        # the ring-highest cells: K on the split dual tile, J on its matvec
        # walk
        ("gram_matmat_dual", "tf32x3"): (
            "gram_tc.cuh", "plssvm_tpu/ops/pallas_matvec.py:812"),
        ("gram_matvec_dual", "highest"): ("dual.cu", "plssvm_tpu/ops/pallas_matvec.py:430"),
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
        # kernel N has no Pallas counterpart: plssvm_tpu builds the explicit
        # matrix in XLA (kernel_matrix_block).  One entry per type and kind
        # the explicit fits ran, each timed at that type and kind:
        # float32 chi-squared at 16384 x 256, float64 chi-squared at 8192 x
        # 256, float32 laplacian at config 2's 9999 x 200; the rect walk
        # the ring's block
        ("kernel_matrix_sym", "chi_squared"): (
            "kernel_matrix.cu", "plssvm_tpu/solver/explicit.py:58"),
        ("kernel_matrix_sym", "f64"): ("kernel_matrix.cu", "plssvm_tpu/solver/explicit.py:58"),
        ("kernel_matrix_sym", "laplacian"): (
            "kernel_matrix.cu", "plssvm_tpu/solver/explicit.py:58"),
        ("kernel_matrix_rect", "chi_squared"): (
            "kernel_matrix.cu", "plssvm_tpu/solver/explicit.py:58"),
        # kernel O has no Pallas counterpart: plssvm_tpu computes the
        # batched pairs product in XLA (solve_ls_svm_pairs' vmapped
        # row-scan matvec).  One entry per walk and tier the oao phase's
        # batched fits ran, timed at that fit's stack: the tensor-core walk
        # at TF32 (d) and bf16 (b), the FFMA walk at "highest" RBF (b) and
        # chi-squared (c), the DMMA walk in float64 (b)
        ("pairs_matvec_tc", "tf32"): ("pairs_tc.cu", "plssvm_tpu/solver/cg.py:1104"),
        ("pairs_matvec_tc", "bf16"): ("pairs_tc.cu", "plssvm_tpu/solver/cg.py:1104"),
        ("pairs_matvec", "rbf"): ("pairs.cu", "plssvm_tpu/solver/cg.py:1104"),
        ("pairs_matvec", "chi_squared"): ("pairs.cu", "plssvm_tpu/solver/cg.py:1104"),
        ("pairs_matvec_dmma", "f64"): ("pairs_tc.cu", "plssvm_tpu/solver/cg.py:1104"),
        # the fixed-order sums of every walk above that sums across blocks:
        # no Pallas kernel of its own, the reference's resident accumulators
        # ("no atomics, no HBM partials"); timed at MNIST width's C, its
        # launches config 2's fit and predict (A and B)
        "fixed_sum": ("fixed_sum.cuh", "plssvm_tpu/ops/pallas_matvec.py:451"),
    }
    entries = [
        {
            "name": k if isinstance(k, str) else k[0], "route": "cuda",
            "source": f"plssvm_tpu_torch/csrc/{src}",
            "replaces": replaces,
            "launches": launches[k if k in launches else k[0]],
            "max_abs_err": main_err[k], "ms": timing[k][0],
            "plain_ms": timing[k][1], "bound_ms": bounds[k][0],
            "bound_by": bounds[k][1], "library_ms": library.get(k),
            **({"tier": k[1]} if isinstance(k, tuple)
               and k[1] in ("tf32", "bf16", "tf32x3", "f64", "highest")
               else {"tier": tiers[k]} if k in tiers else {}),
            **({"on_path": False} if k in OFF_PATH else {}),
            # the multihost phase's launches, every rank's (its own run)
            "multihost_launches": mh_launches.get(k, 0),
            # kernel N's and O's entries: the kind each was timed and
            # launched at
            **({"kind": "chi_squared" if k[1] == "f64" else k[1]}
               if isinstance(k, tuple) and k[0].startswith("kernel_matrix")
               else {"kind": k[1] if k[1] == "chi_squared" else "rbf"}
               if isinstance(k, tuple) and k[0].startswith("pairs_matvec") else {}),
        }
        for k, (src, replaces) in sources.items()
    ]
    idle = [f"{e['name']} {e.get('tier', '')}" for e in entries
            if e["launches"] <= 0 and e.get("on_path", True)]
    if idle:
        raise AssertionError(f"kernels of the main path launched no time: {idle}")
    ffma = [e["name"] for e in entries if not e.get("on_path", True) and e["launches"]]
    if ffma:
        raise AssertionError(f"the FFMA Gram tiles launched on a main path: {ffma}")
    print(smi)
    print(json.dumps({"kernels": entries}))
    # every phase ran on device 0 alone
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name, "count": 1,
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
