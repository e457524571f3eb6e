"""CPU witness for chip_smoke.py's compact phase (c): plssvm_tpu's exact fit
against its ``pruned_fit`` on the phase's own data, in float64.

Usage: JAX_PLATFORMS=cpu python tools/compact_witness.py [n_train]

Draws config 2's two classes and the 10 Gaussian classes exactly as
``chip_smoke.py``'s ``_write_config2`` and ``_write_multiclass`` do (their
generators, seeds and constants; the phase reads them back from LIBSVM
files written with 10 significant digits, this script keeps them in memory)
and fits the reference package (``plssvm_tpu``, ``backend="xla"``, RBF,
C = 1, epsilon EPSILON) exactly and pruned to COMPACT_MAX_SV support
vectors (prune rate 0.25, each refit warm-started).  Prints one line per
cell with the held-out accuracy of both fits.  ``n_train`` keeps the first
rows of each draw only (the default is all 10000, and the pruned
cell's size scales with it).
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
    n_keep = int(argv[0]) if argv else 10000
    n_sv = chip_smoke.COMPACT_MAX_SV * n_keep // 10000
    # _write_config2's draw, in its order
    rng = np.random.default_rng(chip_smoke.SEED)
    config2 = []
    for n in (10000, 2000):
        y = np.where(rng.random(n) < 0.5, -1, 1)
        config2.append((rng.normal(size=(n, 200)) + 0.1 * y[:, None], y))
    # _write_multiclass's draw
    rng = np.random.default_rng(chip_smoke.SEED + 3)
    means = chip_smoke._class_means(rng, 200)
    classes = [chip_smoke._draw(rng, means, n) for n in (10000, 2000)]

    plssvm_tpu.set_verbosity("quiet")
    svm = plssvm_tpu.CSVM(backend="xla", dtype=np.float64, kernel_type="rbf", cost=1.0)
    for label, ((X, y), (X_test, y_test)) in (("config 2", config2),
                                              ("10 classes one-vs-all", classes)):
        train = plssvm_tpu.DataSet(X[:n_keep], y[:n_keep], dtype=np.float64)
        test = plssvm_tpu.DataSet(X_test, y_test, dtype=np.float64)
        exact = svm.fit(train, epsilon=chip_smoke.EPSILON)
        pruned = plssvm_tpu.pruned_fit(svm, train, n_sv=n_sv, epsilon=chip_smoke.EPSILON)
        print(f"compact witness (plssvm_tpu, float64, CPU): {label} {n_keep}x200: held-out "
              f"accuracy exact {svm.score(exact, test):.4f}, pruned to {n_sv} SVs "
              f"{svm.score(pruned, test):.4f}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
