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
   classes, fitted and scored through CSVM in memory.

Before the last line it prints the card's name and power limit as
nvidia-smi reports them, and one JSON object describing each kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the repository around it, the script fails and prints no result.
"""

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
F32_TOL, F64_TOL = 1e-4, 1e-10
SEED = 20261016


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
        got, want = kernel(*args, **kw), plain(*args, **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        if not (torch.isfinite(got).all() and err <= (
            F32_TOL if X.dtype == torch.float32 else F64_TOL
        ) * scale):
            raise AssertionError(
                f"{name} {kind} {X.dtype} {tuple(X.shape)}: max|err| {err} "
                f"vs max|plain| {scale}"
            )
        out[name] = (err, scale)
    return out


def _median_ms(fn, repeats=20):
    for _ in range(2):
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


def _time_pair(name, kernel, plain, args, kw, flops, label):
    """Median ms of the kernel and of its plain version, in the order plain,
    kernel, kernel, plain: the two halves bracket any drift."""
    p1 = _median_ms(lambda: plain(*args, **kw))
    k1 = _median_ms(lambda: kernel(*args, **kw))
    k2 = _median_ms(lambda: kernel(*args, **kw))
    p2 = _median_ms(lambda: plain(*args, **kw))
    k_ms, p_ms = min(k1, k2), min(p1, p2)
    log("kernels", f"{name} {label}: kernel {k_ms:.3f} ms "
        f"({k1:.3f}, {k2:.3f}) = {flops / k_ms / 1e9:.2f} TFLOP/s; plain "
        f"{p_ms:.3f} ms ({p1:.3f}, {p2:.3f}) = {flops / p_ms / 1e9:.2f} "
        "TFLOP/s (counted as 2 m^2 d)")
    return k_ms, p_ms


def phase_kernels():
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
    main_err = {}
    X, P, v = _operands(9999, 200, torch.float32, gen, n_points=2000)
    cfg2 = _compare(K.RBF, 0.0, X, P, v)
    main_err["gram_matvec_sym"] = cfg2["gram_matvec_sym"][0]
    X, P, v = _operands(10000, 200, torch.float32, gen, n_points=2000)
    main_err["gram_matvec_rect"] = _compare(K.RBF, 0.0, X, P, v)["gram_matvec_rect"][0]
    X, P, v = _operands(49999, 500, torch.float32, gen, n_points=1)
    X = X / X.abs().amax(0)  # the [-1, 1] scale of config 3
    cfg3 = _compare(K.POLYNOMIAL, 0.0, X, P / P.abs().amax(0), v)
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
    return main_err, timing


def _write_config2(tmp):
    """Seeded overlapping two-class 10000 x 200 train and 2000 x 200 test
    files, written with the port's LIBSVM writer."""
    from plssvm_tpu_torch import DataSet

    rng = np.random.default_rng(SEED)
    paths = []
    for name, n in (("train", 10000), ("test", 2000)):
        y = np.where(rng.random(n) < 0.5, -1, 1)
        X = rng.normal(size=(n, 200)) + 0.1 * y[:, None]
        path = os.path.join(tmp, f"{name}.libsvm")
        DataSet(X, y).save(path)
        paths.append((path, y))
    return paths


def _tracked(category, name):
    from plssvm_tpu_torch import global_tracker

    values = [v for n, v in global_tracker.entries().get(category, []) if n == name]
    return values[-1]


def phase_end_to_end(tmp):
    import plssvm_tpu_torch as port
    from plssvm_tpu_torch.cli import predict as predict_cli
    from plssvm_tpu_torch.cli import train as train_cli
    from plssvm_tpu_torch.ops import gram_matvec, matvec

    start = time.perf_counter()
    (train_file, _), (test_file, test_labels) = _write_config2(tmp)
    log("e2e", f"wrote 10000x200 + 2000x200 LIBSVM files in "
        f"{time.perf_counter() - start:.2f} s")
    model_file = os.path.join(tmp, "train.model")
    out_file = os.path.join(tmp, "test.predict")
    port.global_tracker.clear()
    common = ["-b", "cuda", "-p", "gpu", "-q"]

    gram_matvec.reset_counts()
    t0 = time.perf_counter()
    rc = train_cli.main(common + ["-t", "2", "-c", "1", "-e", str(EPSILON),
                                  train_file, model_file])
    t1 = time.perf_counter()
    rc_predict = predict_cli.main(common + [test_file, model_file, out_file])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {
        "gram_matvec_sym": gram_matvec.sym_launches,
        "gram_matvec_rect": gram_matvec.rect_launches,
    }
    plain_calls = matvec.sym_plain_calls + matvec.rect_plain_calls
    if rc != 0 or rc_predict != 0:
        raise AssertionError(f"train rc {rc}, predict rc {rc_predict}")

    iterations = _tracked("cg", "iterations")
    cg_ms = _tracked("cg", "total_runtime")
    with open(out_file, encoding="utf-8") as fh:
        predicted = np.asarray([int(line) for line in fh])
    accuracy = float(np.mean(predicted == test_labels))
    log("e2e", f"config 2 f32 (cuda): {iterations} CG iterations, "
        f"{cg_ms / 1000 / iterations:.6f} s/iteration, CG {cg_ms / 1000:.3f} s,"
        f" fit (CLI, parse included) {t1 - t0:.3f} s, predict (CLI) "
        f"{t2 - t1:.3f} s, accuracy {accuracy:.4f}, launches {launches}, "
        f"plain calls {plain_calls}")
    # initial residual, one per iteration, one more every 50th
    expected_sym = 1 + iterations + iterations // 50
    if launches["gram_matvec_sym"] < iterations or launches["gram_matvec_sym"] != expected_sym:
        raise AssertionError(f"kernel A launched {launches['gram_matvec_sym']} "
                             f"times for {iterations} iterations")
    if launches["gram_matvec_rect"] <= 0 or plain_calls != 0:
        raise AssertionError("predict did not go through kernel B only")
    if accuracy < ACCURACY_FLOOR:
        raise AssertionError(f"accuracy {accuracy} below {ACCURACY_FLOOR}")

    # float64 on the card must predict the same labels on >= 99.5 %
    train64 = port.DataSet(train_file, dtype=np.float64)
    test64 = port.DataSet(test_file, dtype=np.float64)
    svm64 = port.CSVM(backend="cuda", device="cuda", dtype=np.float64,
                      kernel_type="rbf", cost=1.0)
    t3 = time.perf_counter()
    model64 = svm64.fit(train64, epsilon=EPSILON)
    t4 = time.perf_counter()
    agree = float(np.mean(svm64.predict(model64, test64) == predicted))
    log("e2e", f"config 2 f64 (cuda): {model64.n_iter} CG iterations, fit "
        f"{t4 - t3:.3f} s, f32/f64 label agreement {agree:.4f}")
    if agree < 0.995:
        raise AssertionError(f"f32 and f64 agree on {agree} of the labels")

    # a small float64 problem: CUDA kernels and plain versions agree
    rng = np.random.default_rng(SEED + 1)
    y = np.where(rng.random(400) < 0.5, -1, 1)
    X = rng.normal(size=(400, 10)) + 0.4 * y[:, None]
    train = port.DataSet(X[:300], y[:300], scaling=(-1.0, 1.0))
    test = port.DataSet(X[300:], y[300:], scaling=train.scaling_factors)
    values = []
    for backend in ("cuda", "torch"):
        svm = port.CSVM(backend=backend, device="cuda", dtype=np.float64,
                        kernel_type="rbf", cost=1.0)
        model = svm.fit(train, epsilon=1e-10)
        values.append((model.rho, svm.predict_values(model, test)))
    drho = abs(values[0][0] - values[1][0])
    dval = float(np.max(np.abs(values[0][1] - values[1][1])))
    log("e2e", f"small f64 fit, kernels vs plain on the card: |d rho| "
        f"{drho:.3e}, max|d f(x)| {dval:.3e}")
    # the kernels' atomics reorder sums from run to run, and CG amplifies
    # that rounding noise (ROADMAP Queue 3); 1e-6 on O(1) values still
    # catches any real difference between the two paths
    if not (np.all(np.isfinite(values[0][1])) and drho <= 1e-6 and dval <= 1e-6):
        raise AssertionError("small f64 fit: kernels and plain versions disagree")
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
    import plssvm_tpu_torch as port
    from plssvm_tpu_torch import DataSet
    from plssvm_tpu_torch.cli import predict as predict_cli
    from plssvm_tpu_torch.cli import train as train_cli
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
    test_labels = files["mc_test"][1]
    log("multiclass", f"wrote {MC_CLASSES}-class 10000x200 + 2000x200 LIBSVM "
        f"files in {time.perf_counter() - start:.2f} s")
    model_file = os.path.join(tmp, "mc_train.model")
    out_file = os.path.join(tmp, "mc_test.predict")
    port.global_tracker.clear()
    common = ["-b", "cuda", "-p", "gpu", "-q"]

    gram_matvec.reset_counts()
    gram_matmat.reset_counts()
    t0 = time.perf_counter()
    rc = train_cli.main(common + ["-t", "2", "-c", "1", "-e", str(EPSILON),
                                  train_file, model_file])
    t1 = time.perf_counter()
    rc_predict = predict_cli.main(common + [test_file, model_file, out_file])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {
        "gram_matmat_sym": gram_matmat.sym_launches,
        "gram_matmat_rect": gram_matmat.rect_launches,
    }
    plain_calls = matvec.sym_matmat_plain_calls + matvec.rect_matmat_plain_calls
    binary_launches = gram_matvec.sym_launches + gram_matvec.rect_launches
    if rc != 0 or rc_predict != 0:
        raise AssertionError(f"train rc {rc}, predict rc {rc_predict}")

    iterations = _tracked("cg", "iterations")
    per_class = _tracked("cg", "iterations_per_class")
    cg_ms = _tracked("cg", "total_runtime")
    with open(out_file, encoding="utf-8") as fh:
        predicted = np.asarray([int(line) for line in fh])
    accuracy = float(np.mean(predicted == test_labels))
    log("multiclass", f"{MC_CLASSES} classes f32 (cuda): {iterations} block-CG "
        f"iterations (per class {per_class}), "
        f"{cg_ms / 1000 / iterations:.6f} s/iteration, CG {cg_ms / 1000:.3f} s, "
        f"fit (CLI, parse included) {t1 - t0:.3f} s, predict (CLI) "
        f"{t2 - t1:.3f} s, accuracy {accuracy:.4f}, launches {launches}, "
        f"matmat plain calls {plain_calls}, matvec launches {binary_launches}")
    # initial residual, one per iteration, one more every 50th
    expected = 1 + iterations + iterations // 50
    if launches["gram_matmat_sym"] != expected:
        raise AssertionError(f"kernel C launched {launches['gram_matmat_sym']} "
                             f"times for {iterations} iterations")
    if launches["gram_matmat_rect"] <= 0 or plain_calls != 0:
        raise AssertionError("multiclass predict did not go through kernel D only")
    if accuracy < MC_ACCURACY_FLOOR:
        raise AssertionError(f"accuracy {accuracy} below {MC_ACCURACY_FLOOR}")

    # float64 on the card must predict the same labels on >= 99.5 %
    train64 = port.DataSet(train_file, dtype=np.float64)
    test64 = port.DataSet(test_file, dtype=np.float64)
    svm64 = port.CSVM(backend="cuda", device="cuda", dtype=np.float64,
                      kernel_type="rbf", cost=1.0)
    t3 = time.perf_counter()
    model64 = svm64.fit(train64, epsilon=EPSILON)
    t4 = time.perf_counter()
    agree = float(np.mean(svm64.predict(model64, test64) == predicted))
    log("multiclass", f"{MC_CLASSES} classes f64 (cuda): {model64.n_iter} "
        f"block-CG iterations, fit {t4 - t3:.3f} s, f32/f64 label agreement "
        f"{agree:.4f}")
    if agree < 0.995:
        raise AssertionError(f"f32 and f64 agree on {agree} of the labels")

    # a small float64 four-class problem: CUDA kernels and plain versions agree
    rng = np.random.default_rng(SEED + 5)
    y = rng.integers(0, 4, 400)
    X = rng.normal(size=(400, 10)) + rng.normal(size=(4, 10))[y]
    train = port.DataSet(X[:300], y[:300], scaling=(-1.0, 1.0))
    test = port.DataSet(X[300:], y[300:], scaling=train.scaling_factors)
    values = []
    for backend in ("cuda", "torch"):
        svm = port.CSVM(backend=backend, device="cuda", dtype=np.float64,
                        kernel_type="rbf", cost=1.0)
        model = svm.fit(train, epsilon=1e-10)
        values.append((model.rho, svm.predict_values(model, test)))
    drho = float(np.max(np.abs(values[0][0] - values[1][0])))
    dval = float(np.max(np.abs(values[0][1] - values[1][1])))
    log("multiclass", f"small 4-class f64 fit, kernels vs plain on the card: "
        f"max|d rho| {drho:.3e}, max|d f(x)| {dval:.3e}")
    # as in phase 4: the atomics' summation order, amplified by CG
    if not (np.all(np.isfinite(values[0][1])) and drho <= 1e-6 and dval <= 1e-6):
        raise AssertionError("small multiclass fit: kernels and plain versions disagree")
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


def phase_config3_width():
    import plssvm_tpu_torch as port

    rng = np.random.default_rng(SEED + 2)
    n, d = 50000, 500
    y = np.where(rng.random(n) < 0.5, -1, 1)
    X = rng.normal(size=(n, d)) + 0.05 * y[:, None]
    data = port.DataSet(X, y, scaling=(-1.0, 1.0), dtype=np.float32)
    svm = port.CSVM(backend="cuda", device="cuda", dtype=np.float32,
                    kernel_type="polynomial")
    port.global_tracker.clear()
    t0 = time.perf_counter()
    model = svm.fit(data, epsilon=1e-12, max_iter=20)
    t1 = time.perf_counter()
    iterations = _tracked("cg", "iterations")
    cg_ms = _tracked("cg", "total_runtime")
    if not np.all(np.isfinite(model.alpha)) or not np.isfinite(model.rho):
        raise AssertionError("config 3 width: non-finite model")
    log("config3", f"poly 50000x500 f32 (cuda): {iterations} CG iterations, "
        f"{cg_ms / 1000 / iterations:.6f} s/iteration, fit {t1 - t0:.3f} s")


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
    main_err, timing = run("kernels", phase_kernels)
    with tempfile.TemporaryDirectory() as tmp:
        launches = run("e2e", phase_end_to_end, tmp)
        launches.update(run("multiclass", phase_multiclass_cli, tmp))
    run("config3", phase_config3_width)
    run("mnist-width", phase_multiclass_width)
    log("times", ", ".join(f"{k} {v:.1f} s" for k, v in phase_seconds.items()))

    sources = {
        "gram_matvec_sym": ("gram_matvec.cu", "plssvm_tpu/ops/pallas_matvec.py:430"),
        "gram_matvec_rect": ("gram_matvec.cu", "plssvm_tpu/ops/pallas_matvec.py:1007"),
        "gram_matmat_sym": ("gram_matmat.cu", "plssvm_tpu/ops/pallas_matvec.py:812"),
        "gram_matmat_rect": ("gram_matmat.cu", "plssvm_tpu/ops/pallas_matvec.py:812"),
    }
    print(smi)
    print(json.dumps({"kernels": [
        {
            "name": k, "route": "cuda",
            "source": f"plssvm_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": launches[k],
            "max_abs_err": main_err[k], "ms": timing[k][0],
            "plain_ms": timing[k][1],
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
