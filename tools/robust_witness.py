"""CPU witness for chip_smoke.py's robust phase: plssvm_tpu's plain fit
against its ``reweighted_fit`` on the phase's own data, in float64.

Usage: JAX_PLATFORMS=cpu python tools/robust_witness.py [n_train]

Draws Friedman #1 exactly as ``chip_smoke.py::phase_robust`` does (its
generator, seed and constants: ROBUST_N training rows, ROBUST_TEST held-out
rows, ROBUST_SHARE of the training targets shifted by ROBUST_SHIFT standard
deviations), and fits the reference package (``plssvm_tpu``,
``backend="xla"``, RBF, C = 10, epsilon FRIEDMAN_EPSILON) plain and with
ROBUST_REFITS reweighted refits, once with every shift upward and once with
each shift's sign drawn at random.  Prints one line per side with the
held-out R^2 of both fits against the clean targets.  ``n_train`` keeps the
first rows of the phase's draw only (the default is all of ROBUST_N).
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import chip_smoke  # noqa: E402
import plssvm_tpu  # noqa: E402


def main(argv):
    n_keep = int(argv[0]) if argv else chip_smoke.ROBUST_N
    N, T = chip_smoke.ROBUST_N, chip_smoke.ROBUST_TEST
    # phase_robust's draw, in its order
    rng = np.random.default_rng(chip_smoke.SEED + 60)
    X, y_noisy = chip_smoke._friedman1(rng, N + T)
    clean = (10.0 * np.sin(np.pi * X[:, 0] * X[:, 1]) + 20.0 * (X[:, 2] - 0.5) ** 2
             + 10.0 * X[:, 3] + 5.0 * X[:, 4])
    bad = rng.choice(N, int(chip_smoke.ROBUST_SHARE * N), replace=False)
    signs = rng.choice([-1.0, 1.0], len(bad))

    plssvm_tpu.set_verbosity("quiet")
    svm = plssvm_tpu.CSVM(backend="xla", dtype=np.float64, kernel_type="rbf", cost=10.0)
    test = plssvm_tpu.DataSet(X[N:], clean[N:], regression=True, dtype=np.float64)
    for side, sign in (("one-sided", 1.0), ("symmetric", signs)):
        y = y_noisy[:N].copy()
        y[bad] += chip_smoke.ROBUST_SHIFT * y.std() * sign
        train = plssvm_tpu.DataSet(X[:n_keep], y[:n_keep], regression=True,
                                   dtype=np.float64)
        plain = svm.fit(train, epsilon=chip_smoke.FRIEDMAN_EPSILON)
        robust = plssvm_tpu.reweighted_fit(svm, train, iterations=chip_smoke.ROBUST_REFITS,
                                           epsilon=chip_smoke.FRIEDMAN_EPSILON)
        r2 = (svm.score(plain, test), svm.score(robust, test))
        print(f"robust witness (plssvm_tpu, float64, CPU): Friedman #1 {n_keep}x"
              f"{chip_smoke.FRIEDMAN_D}, {int(np.sum(bad < n_keep))} targets shifted by "
              f"{chip_smoke.ROBUST_SHIFT} sd, {side}: held-out R^2 against the clean "
              f"targets: plain {r2[0]:.4f}, robust {r2[1]:.4f}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
