"""Synthetic data set generator.

reference: utility_scripts/generate_data.py:17-60 — creates classification
data sets (blobs / gaussian quantiles / ...) and writes libsvm/arff/csv.
Uses sklearn when available, otherwise a built-in NumPy blobs generator so
the tool works in minimal environments.  Counterpart of
plssvm_tpu/cli/generate_data.py: the same arguments and seed give the same
file where both packages see the same sklearn (or none).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..data_set import DataSet


def make_blobs_numpy(n: int, d: int, seed: int = 0, classes: int = 2):
    """Gaussian blobs, the sklearn-free fallback generator."""
    rng = np.random.default_rng(seed)
    centers = 3.0 * rng.normal(size=(classes, d))
    if classes == 2:
        centers = np.stack([-2.0 * np.ones(d), 2.0 * np.ones(d)])
    assignment = np.repeat(np.arange(classes), -(-n // classes))[:n]
    X = centers[assignment] + rng.normal(size=(n, d))
    y = assignment.astype(np.int64)
    if classes == 2:
        y = np.where(y == 0, -1, 1)
    perm = rng.permutation(n)
    return X[perm], y[perm]


def make_regression_numpy(n: int, d: int, seed: int = 0, noise: float = 0.1):
    """Linear regression targets, the sklearn-free fallback."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    w = rng.normal(size=d)
    y = X @ w + noise * rng.normal(size=n)
    return X, y


def generate(
    n: int, d: int, *, problem: str = "blobs", seed: int = 0, classes: int = 2
):
    """Generate (X, y): labels {-1, +1} for 2 classes, 0..C-1 otherwise.

    ``classes > 2`` feeds the one-vs-all multiclass extension (the reference
    generator is binary-only, utility_scripts/generate_data.py).
    ``problem="regression"`` always uses the built-in NumPy generator so the
    same seed emits identical data with or without sklearn installed.
    """
    if problem == "regression":
        return make_regression_numpy(n, d, seed)
    try:
        from sklearn import datasets  # type: ignore

        if problem == "blobs":
            X, y = datasets.make_blobs(
                n_samples=n, n_features=d, centers=classes, random_state=seed
            )
        elif problem == "planes":
            # make_classification requires
            # n_classes * n_clusters_per_class(=2) <= 2**n_informative
            n_informative = max(2, int(np.ceil(np.log2(2 * classes))))
            X, y = datasets.make_classification(
                n_samples=n, n_features=max(d, n_informative),
                n_redundant=0, n_classes=classes,
                n_informative=n_informative,
                random_state=seed,
            )
            X = X[:, :d]
        elif problem == "gaussian":
            X, y = datasets.make_gaussian_quantiles(
                n_samples=n, n_features=d, n_classes=classes, random_state=seed
            )
        else:
            raise ValueError(f"unknown problem type '{problem}'")
        if classes == 2:
            y = np.where(y == 0, -1, 1)
        return X, y
    except ImportError:
        return make_blobs_numpy(n, d, seed, classes)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="plssvm-torch-generate-data",
        description="generate synthetic classification data sets",
    )
    parser.add_argument("--output", "-o", required=True, help="the output file")
    parser.add_argument("--format", "-f", default="libsvm",
                        choices=["libsvm", "arff"], help="output format")
    parser.add_argument("--problem", default="blobs",
                        choices=["blobs", "planes", "gaussian", "regression"],
                        help="'regression' emits continuous targets for "
                             "LS-SVR training (plssvm-train -s epsilon_svr)")
    parser.add_argument("--samples", "-n", type=int, required=True)
    parser.add_argument("--classes", "-c", type=int, default=2,
                        help="number of classes (> 2 uses the one-vs-all "
                             "multiclass extension)")
    parser.add_argument("--features", "-d", type=int, required=True)
    parser.add_argument("--seed", type=int, default=0)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    X, y = generate(args.samples, args.features, problem=args.problem,
                    seed=args.seed, classes=args.classes)
    ds = DataSet(X, y, regression=(args.problem == "regression"))
    ds.save(args.output, file_format=args.format)
    return 0


if __name__ == "__main__":
    sys.exit(main())
