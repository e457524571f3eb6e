"""The C-SVM front end: fit / predict / score on one PyTorch device.

Counterpart of plssvm_tpu/csvm.py (reference: include/plssvm/csvm.hpp:129-375
and include/plssvm/csvm_factory.hpp:123-171).  ``CSVM`` resolves its device
once, at construction, and creates every tensor there; nothing is moved
between devices behind the caller's back.  The backend picks the kernel
products: ``cuda``, the hand-written kernels (csrc/*.cu), or ``torch``,
their plain PyTorch versions on any device.

This package covers binary and one-vs-all multiclass classification with
the implicit CG solver, for every kernel function (linear, polynomial, RBF,
sigmoid, laplacian, chi-squared), on one device or row-sharded over a list
of devices (``devices``, parallel/sharded.py), and predict with binary,
one-vs-all and one-vs-one (LIBSVM multiclass) model files.
What it does not carry yet raises :class:`NotPortedError` (a
``NotImplementedError``) naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import time
from typing import Optional, Union

import numpy as np
import torch

from .data_set import DataSet
from .exceptions import InvalidParameterError, NotPortedError, UnsupportedBackendError
from .model import Model
from .ops.predict import calculate_w, predict_values as predict_values_op
from .parallel.sharded import (
    predict_values_sharded,
    solve_ls_svm_multi_sharded,
    solve_ls_svm_sharded,
)
from .parameter import (
    BackendType,
    ClassificationType,
    KernelFunctionType,
    Parameter,
    TargetPlatform,
)
from .solver.cg import solve_ls_svm, solve_ls_svm_multi
from .utils.logger import VerbosityLevel, log
from .utils.tracker import add_tracking_entry

_REAL_DTYPES = (np.dtype(np.float32), np.dtype(np.float64))


def _check_chi_squared_data(X: np.ndarray, what: str) -> None:
    """The chi-squared kernel is only defined for non-negative data."""
    lo = float(np.min(X)) if X.size else 0.0
    if lo < 0.0:
        raise InvalidParameterError(
            f"The chi-squared kernel requires non-negative values, but the "
            f"{what} contains {lo}!"
        )


def _resolve_device(target: TargetPlatform, device) -> torch.device:
    """The one device a CSVM computes on."""
    if device is not None:
        dev = torch.device(device)
        if dev.type not in ("cpu", "cuda"):
            raise UnsupportedBackendError(f"Unsupported device '{dev}'!")
        if (target == TargetPlatform.CPU and dev.type != "cpu") or (
            target == TargetPlatform.GPU and dev.type != "cuda"
        ):
            raise InvalidParameterError(
                f"device '{dev}' contradicts target platform '{target}'!"
            )
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise UnsupportedBackendError("CUDA is not available here!")
        return dev
    if target == TargetPlatform.TPU:
        raise UnsupportedBackendError(
            "plssvm_tpu_torch runs on CPUs and NVIDIA GPUs; use plssvm_tpu "
            "for TPUs!"
        )
    if target == TargetPlatform.CPU:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        # automatic never falls back to the CPU: the caller asks for it
        raise UnsupportedBackendError(
            f"target platform '{target}' needs a CUDA device, but CUDA is not "
            "available!  Ask for the CPU explicitly: target='cpu' or "
            "device='cpu' (CLI: -p cpu)."
        )
    return torch.device("cuda", torch.cuda.current_device())


def _resolve_devices(devices, device, target: TargetPlatform) -> Optional[list]:
    """The shard devices of a CSVM, or None for the single-device path.

    ``"all"``: every CUDA device.  None: every CUDA device when there are
    more than one, no ``device`` is pinned and ``target`` is not the CPU.
    A list: one shard per entry, entries may repeat.  Fewer than two
    entries take the single-device path.  A list that mixes ``cpu`` and
    ``cuda`` raises.
    """
    if devices is None:
        if (device is None and target != TargetPlatform.CPU
                and torch.cuda.is_available() and torch.cuda.device_count() > 1):
            devices = "all"
        else:
            return None
    if isinstance(devices, str):
        if devices != "all":
            raise InvalidParameterError(
                f"devices must be None, 'all' or a list of devices, not {devices!r}!"
            )
        if not torch.cuda.is_available():
            raise UnsupportedBackendError(
                "devices='all' takes every CUDA device, but CUDA is not available!"
            )
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    resolved = [torch.device(d) for d in devices]
    kinds = {d.type for d in resolved}
    if not kinds <= {"cpu", "cuda"}:
        raise UnsupportedBackendError(f"Unsupported devices {sorted(kinds)}!")
    if len(kinds) > 1:
        raise InvalidParameterError(
            "devices mixes cpu and cuda: every shard of a solve lies on one "
            "kind of device!"
        )
    return resolved


class CSVM:
    """LS-SVM classifier trained with matrix-free Conjugate Gradient.

    reference: include/plssvm/csvm.hpp (fit 263-323, predict 325-343,
    score 345-375).

    ``device`` (e.g. ``"cuda:0"``) pins the device; by default ``target``
    decides, and ``automatic`` takes the current CUDA device and raises
    :class:`UnsupportedBackendError` when there is none: the CPU runs only
    when asked for (``target="cpu"`` or ``device="cpu"``).
    ``backend=automatic`` takes the CUDA kernels on a CUDA device and the
    plain PyTorch versions on the CPU.

    ``devices`` row-shards fit and predict (reference: plssvm_tpu/csvm.py
    ``devices``): ``"all"`` every CUDA device; a list one shard per entry,
    entries may repeat (``["cuda:0"] * 4``: four shards on one card); None
    every CUDA device when there are more than one and no ``device`` is
    pinned.  Fewer than two entries take the single-device path; the first
    entry is the device the CG vectors and the results lie on.  A list that
    mixes ``cpu`` and ``cuda``, or names ``cpu`` under the ``cuda``
    backend, raises.
    """

    def __init__(
        self,
        backend: Union[str, BackendType] = BackendType.AUTOMATIC,
        target: Union[str, TargetPlatform] = TargetPlatform.AUTOMATIC,
        *,
        params: Optional[Parameter] = None,
        dtype=np.float32,
        device=None,
        preconditioner: str = "none",
        scalar_precision: str = "auto",
        gram_precision: str = "f32",
        solver: str = "automatic",
        devices=None,
        **named_params,
    ):
        backend = BackendType.from_string(backend)
        self.target = TargetPlatform.from_string(target)
        shard_devices = _resolve_devices(devices, device, self.target)
        if shard_devices is not None and devices is not None:
            if device is not None and torch.device(device) != shard_devices[0]:
                raise InvalidParameterError(
                    f"device '{device}' contradicts devices, whose first entry "
                    f"is '{shard_devices[0]}'!"
                )
            device = shard_devices[0]
        self.device = _resolve_device(self.target, device)
        if backend == BackendType.AUTOMATIC:
            backend = (
                BackendType.CUDA if self.device.type == "cuda"
                else BackendType.TORCH
            )
        self.backend = backend
        if shard_devices is not None:
            if backend == BackendType.CUDA and any(d.type == "cpu" for d in shard_devices):
                raise InvalidParameterError(
                    "devices names the CPU while the backend is cuda: the CUDA "
                    "kernels do not run there!"
                )
            for dev in shard_devices:
                _resolve_device(self.target, dev)
        #: the shard devices of fit and predict, or None: one device
        self.devices = shard_devices if shard_devices and len(shard_devices) > 1 else None
        self.dtype = np.dtype(dtype)
        if self.dtype not in _REAL_DTYPES:
            raise InvalidParameterError(
                f"dtype must be float32 or float64, but is {self.dtype}!"
            )
        if preconditioner not in ("none", "jacobi"):
            raise InvalidParameterError(
                f"Unrecognized preconditioner '{preconditioner}' "
                "(must be 'none' or 'jacobi')!"
            )
        if preconditioner == "jacobi":
            raise NotPortedError(
                "preconditioner='jacobi' is not ported yet (ROADMAP Queue 1, "
                "item 4: solver extras)"
            )
        # CG scalar accumulation: "compensated" emulates the reference's f64
        # scalar accumulators with double-float TwoSum folds; "auto" turns it
        # on for f32 solves, like plssvm_tpu
        if scalar_precision not in ("auto", "plain", "compensated"):
            raise InvalidParameterError(
                f"Unrecognized scalar_precision '{scalar_precision}' "
                "(must be 'auto', 'plain' or 'compensated')!"
            )
        if scalar_precision == "auto":
            scalar_precision = (
                "compensated" if self.dtype == np.float32 else "plain"
            )
        self.scalar_precision = scalar_precision
        if gram_precision not in ("f32", "bf16", "highest"):
            raise InvalidParameterError(
                f"Unrecognized gram_precision '{gram_precision}' "
                "(must be 'f32', 'bf16' or 'highest')!"
            )
        # the Gram tier of the CUDA kernels, training and predict alike
        # (solver/cg.py, ops/predict.py); the torch backend ignores it
        self.gram_precision = gram_precision
        if solver not in ("automatic", "cg_explicit", "cg_implicit"):
            raise InvalidParameterError(
                f"Unrecognized solver '{solver}' (must be 'automatic', "
                "'cg_explicit' or 'cg_implicit')!"
            )
        if solver == "cg_explicit":
            raise NotPortedError(
                "solver='cg_explicit' is not ported yet (ROADMAP Queue 1, "
                "item 3: the explicit solver)"
            )
        # automatic resolves to the implicit solver until the explicit one
        # is ported
        self.solver = "cg_implicit"

        self._params = params.copy() if params is not None else Parameter()
        if named_params:
            provided = Parameter(**named_params)
            self._params.merge_non_defaults(provided)
        self._params.sanity_check()

        # construction-time tracking entries, mirroring the reference's
        # backend init (src/plssvm/backends/CUDA/csvm.cu:48-86)
        platform = (
            TargetPlatform.GPU if self.device.type == "cuda"
            else TargetPlatform.CPU
        )
        add_tracking_entry("backend", "backend", str(self.backend))
        add_tracking_entry("backend", "target_platform", str(platform))
        names = [str(d) for d in self.devices] if self.devices else [str(self.device)]
        add_tracking_entry("backend", "device", ", ".join(names))
        add_tracking_entry("backend", "num_devices", len(names))
        log(
            VerbosityLevel.FULL,
            "\nUsing {} as backend on {} device(s) {} ({}).\n",
            self.backend, len(names), ", ".join(names), platform,
        )

    # -- parameters --------------------------------------------------------
    @property
    def params(self) -> Parameter:
        return self._params

    def get_params(self) -> Parameter:
        return self._params.copy()

    def set_params(self, params: Optional[Parameter] = None, **named_params) -> None:
        """Override hyperparameters with user-set values (csvm.hpp:243-257)."""
        if params is not None:
            self._params = params.copy()
        if named_params:
            provided = Parameter(**named_params)
            self._params.merge_non_defaults(provided)
        self._params.sanity_check()

    def _tensor(self, array) -> torch.Tensor:
        return torch.as_tensor(
            np.ascontiguousarray(array, dtype=self.dtype), device=self.device
        )

    def _impl(self) -> str:
        return "cuda" if self.backend == BackendType.CUDA else "torch"

    # -- fit ----------------------------------------------------------------
    def fit(
        self,
        data: DataSet,
        *,
        epsilon: float = 0.001,
        max_iter: Optional[int] = None,
        classification: Union[str, ClassificationType] = ClassificationType.OAA,
        initial_model: Optional[Model] = None,
        sample_weight=None,
        checkpoint_path: Optional[str] = None,
    ) -> Model:
        """Solve the LS-SVM dual with CG and return the model.

        Defaults: ``epsilon = 1e-3`` (relative, squared residual),
        ``max_iter = num_data_points`` (reference: csvm.hpp:268-269).
        Data with more than two labels trains one-vs-all (``classification
        = "oaa"``, the default): the C binary systems share the implicit
        matrix and are solved together as one block CG (an extension; the
        reference rejects such data, data_set.hpp:443).  With ``devices``
        both run row-sharded (parallel/sharded.py).  One-vs-one training,
        ``initial_model``, ``sample_weight`` and ``checkpoint_path`` are not
        ported yet.
        """
        if epsilon <= 0.0:
            raise InvalidParameterError(
                f"epsilon must be greater than 0.0, but is {epsilon}!"
            )
        if not data.has_labels():
            raise InvalidParameterError(
                "No labels given for training! Maybe the data is only usable for prediction?"
            )
        if max_iter is None:
            max_iter = data.num_data_points
        elif max_iter <= 0:
            raise InvalidParameterError(
                f"max_iter must be greater than 0, but is {max_iter}!"
            )
        classification = ClassificationType.from_string(classification)
        if initial_model is not None or sample_weight is not None or checkpoint_path is not None:
            raise NotPortedError(
                "initial_model, sample_weight and checkpoint_path are not ported "
                "yet (ROADMAP Queue 1, item 4: solver extras)"
            )
        if data.is_regression:
            raise NotPortedError(
                "regression is not ported yet (ROADMAP Queue 1, item 7: "
                "regression and one-class)"
            )
        multiclass = data.num_different_labels > 2
        kind = self._params.kernel_type.value
        if kind == KernelFunctionType.CHI_SQUARED:
            _check_chi_squared_data(np.asarray(data.data), "training data")
        if multiclass and classification == ClassificationType.OAO:
            raise NotPortedError(
                "one-vs-one training is not ported yet (ROADMAP Queue 1, "
                "item 6: one-vs-one)"
            )

        params = self._params.copy()
        if params.gamma.is_default():
            # gamma default = 1 / num_features (reference: csvm.hpp:304-307)
            params.gamma.value = 1.0 / data.num_features
        degree = params.degree.value
        start = time.perf_counter()

        # the kernels mask ragged edges: the system keeps its dept rows
        transform_start = time.perf_counter()
        X = self._tensor(data.data)
        if multiclass:
            y = self._tensor(data.mapper.oaa_targets(data.labels))  # (n, C)
        else:
            y = self._tensor(data.y)
        n, d = X.shape
        dept = n - 1
        add_tracking_entry("transform", "num_data_points", int(dept))
        add_tracking_entry("transform", "num_features", int(d))
        add_tracking_entry("transform", "layout", "dense (torch)")
        add_tracking_entry(
            "transform", "time", (time.perf_counter() - transform_start) * 1000.0
        )
        add_tracking_entry("cg", "solver", self.solver)

        solve_kw = dict(
            kind=kind, degree=degree, impl=self._impl(),
            scalars=self.scalar_precision, gram_precision=self.gram_precision,
        )
        solve_args = (
            params.resolved_gamma(d), params.coef0.value, params.cost.value,
            epsilon, max_iter,
        )
        if self.devices is not None:
            solve_kw["devices"] = self.devices
        if multiclass:
            solve = solve_ls_svm_multi_sharded if self.devices else solve_ls_svm_multi
            result = solve(X[:dept], X[-1], y[:dept], y[-1], *solve_args, **solve_kw)
            alpha = np.vstack(
                [result.x.cpu().numpy(), result.alpha_last.cpu().numpy()[None, :]]
            ).astype(self.dtype)
            rho = result.rho.cpu().numpy().astype(np.float64)
            # report the worst (last-converging) class in the scalar log line
            delta_arr = result.delta.cpu().numpy()
            delta0_arr = result.delta0.cpu().numpy()
            worst = int(np.argmax(delta_arr / np.maximum(delta0_arr, 1e-300)))
            delta = float(delta_arr[worst])
            delta0 = float(delta0_arr[worst])
        else:
            solve = solve_ls_svm_sharded if self.devices else solve_ls_svm
            result = solve(
                X[:dept], X[-1], y[:dept], float(data.y[-1]), *solve_args,
                **solve_kw,
            )
            alpha = np.concatenate(
                [result.x.cpu().numpy(), [float(result.alpha_last)]]
            ).astype(self.dtype)
            rho = float(result.rho)
            delta = float(result.delta)
            delta0 = float(result.delta0)
        iterations = result.iterations
        total_ms = (time.perf_counter() - start) * 1000.0

        log(
            VerbosityLevel.FULL | VerbosityLevel.TIMING,
            "Finished after {}/{} iterations with a residuum of {} (target: {}).\n",
            iterations, max_iter, delta, epsilon * epsilon * delta0,
        )
        log(VerbosityLevel.LIBSVM, "optimization finished, #iter = {}\n", iterations)
        log(
            VerbosityLevel.FULL | VerbosityLevel.TIMING,
            "Solved minimization problem (r = b - Ax) using the Conjugate Gradient (CG) methode in {:.2f}ms.\n\n",
            total_ms,
        )
        add_tracking_entry("cg", "iterations", iterations)
        if multiclass:
            add_tracking_entry(
                "cg", "iterations_per_class",
                result.iterations_per_class.cpu().tolist(),
            )
        add_tracking_entry("cg", "max_iterations", int(max_iter))
        add_tracking_entry("cg", "residuum", delta)
        add_tracking_entry("cg", "target_residuum", epsilon * epsilon * delta0)
        add_tracking_entry("cg", "epsilon", epsilon)
        add_tracking_entry(
            "cg", "avg_iteration_time", total_ms / max(iterations, 1)
        )
        add_tracking_entry("cg", "total_runtime", total_ms)

        model = Model(params, data, alpha=alpha, rho=rho)
        model.n_iter = iterations
        return model

    # -- predict ------------------------------------------------------------
    def predict_values(self, model: Model, data: DataSet) -> np.ndarray:
        """Decision values f(x) = sum_i alpha_i k(sv_i, x) - rho.

        reference: csvm.hpp:325-343 + gpu_csvm.hpp:656-730.

        Binary models return shape (n_pred,); one-vs-all models (n_pred, C),
        one decision column per class; one-vs-one models (n_pred,
        C(C-1)/2), one column per pair machine in LIBSVM order
        (:func:`plssvm_tpu_torch.oao.class_pairs`).
        """
        if model.num_features != data.num_features:
            raise InvalidParameterError(
                f"Number of features per data point ({data.num_features}) must match "
                f"the number of features per support vector of the provided model "
                f"({model.num_features})!"
            )
        if (
            model.classification == ClassificationType.OAO
            and np.ndim(model.alpha) == 2
        ):
            return self._predict_values_oao(model, data)
        if model.is_regression or model.is_one_class:
            raise NotPortedError(
                "regression and one-class models are not ported yet (ROADMAP "
                "Queue 1, item 7: regression and one-class)"
            )
        params = model.params
        kind = params.kernel_type.value
        if kind == KernelFunctionType.CHI_SQUARED:
            _check_chi_squared_data(np.asarray(data.data), "predict points")
        sv = self._tensor(model.support_vectors)
        alpha = self._tensor(model.alpha)
        points = self._tensor(data.data)
        w = None
        if kind == KernelFunctionType.LINEAR:
            # w derives from BOTH alpha and the SVs — recompute the cached
            # weights when either array was replaced
            if (
                model.w is None
                or getattr(model, "_w_alpha", None) is not model.alpha
                or getattr(model, "_w_sv", None) is not model.support_vectors
            ):
                # compute & cache w once (gpu_csvm.hpp:696-705,
                # model.hpp:162-166); (d,) binary or (d, C) multiclass
                model.w = calculate_w(sv, alpha).cpu().numpy()
                model._w_alpha = model.alpha
                model._w_sv = model.support_vectors
            w = self._tensor(model.w)
        rho = (
            self._tensor(model.rho) if np.ndim(model.rho) > 0
            else float(model.rho)
        )
        kw = dict(kind=kind, degree=params.degree.value, impl=self._impl(),
                  precision=self.gram_precision)
        gamma = params.resolved_gamma(model.num_features)
        if self.devices is not None and w is None:
            # the support vectors row-sharded, the points on every shard
            values = predict_values_sharded(
                sv, alpha, rho, points, gamma, params.coef0.value,
                devices=self.devices, **kw,
            )
        else:
            values = predict_values_op(
                sv, alpha, rho, w, points, gamma, params.coef0.value, **kw
            )
        return values.cpu().numpy()

    def _predict_values_oao(self, model: Model, data: DataSet) -> np.ndarray:
        """One-vs-one decision values as ONE kernel matmat.

        The sv_coef block expands once into the dense (n_sv, n_machines)
        weight matrix W (:func:`plssvm_tpu_torch.oao.model_weight_matrix`)
        and all machines evaluate together as ``K(points, SV) @ W - rho``
        through a cached shadow one-vs-all model, so kernel D serves them.
        """
        cached = getattr(model, "_oao_shadow", None)
        if cached is not None and cached[0] is model.alpha:
            shadow = cached[1]
        else:
            from . import oao

            # the expansion follows the model's LAYOUT class order (the
            # file's label-header order for loaded models)
            shadow = Model(
                model.params, model.data, alpha=oao.model_weight_matrix(model),
                rho=np.atleast_1d(np.asarray(model.rho, dtype=np.float64)),
            )
            model._oao_shadow = (model.alpha, shadow)
        return self.predict_values(shadow, data)

    def fit_multihost(self, filename: str, **kwargs) -> Model:
        """The multi-host fit of plssvm_tpu (each host parses its row window
        of ``filename``, the solve runs over every host's devices): not
        ported yet."""
        raise NotPortedError(
            "fit_multihost is not ported yet (ROADMAP Queue 1, item 10: "
            "parallel/multihost.py on torch.distributed)"
        )

    def predict(self, model: Model, data: DataSet) -> np.ndarray:
        """Predicted labels mapped back to the original label type.

        Binary: sign(f), with sign(0) = -1 like the reference
        (operators.hpp:179-181).  Multiclass: argmax over the C one-vs-all
        decision columns, or pairwise voting for one-vs-one models
        (LIBSVM's svm_predict semantics, :func:`plssvm_tpu_torch.oao.vote`).
        """
        values = self.predict_values(model, data)
        if values.ndim == 2:
            # columns / machines follow the model's LAYOUT class order — the
            # file's label-header order for loaded models
            order_arr = np.asarray(model.class_order())
            if model.classification == ClassificationType.OAO:
                from . import oao

                return order_arr[oao.vote(values, model.num_classes)]
            return order_arr[np.argmax(values, axis=1)]
        if model.label_order is not None:
            # file-loaded binary model: libsvm's svm_predict rule is
            # f > 0 -> label[0] (the header's FIRST label — appearance
            # order, not sorted)
            order_arr = np.asarray(model.label_order)
            return order_arr[(values <= 0).astype(np.intp)]
        labels_arr = np.asarray(model.data.mapper.labels())
        return labels_arr[(values > 0).astype(np.intp)]

    def score(self, model: Model, data: Optional[DataSet] = None) -> float:
        """Classification accuracy (reference: csvm.hpp:345-375)."""
        if data is None:
            data = model.data
        if not data.has_labels():
            raise InvalidParameterError("The data set to score must have labels!")
        if model.num_features != data.num_features:
            raise InvalidParameterError(
                f"Number of features per data point ({data.num_features}) must match "
                f"the number of features per support vector of the provided model "
                f"({model.num_features})!"
            )
        predicted = self.predict(model, data)
        correct = int(np.sum(predicted == np.asarray(data.labels)))
        return correct / len(predicted)


def make_csvm(
    backend: Union[str, BackendType] = BackendType.AUTOMATIC,
    target: Union[str, TargetPlatform] = TargetPlatform.AUTOMATIC,
    **kwargs,
) -> CSVM:
    """Factory mirroring the reference's make_csvm (csvm_factory.hpp:123-171)."""
    return CSVM(backend=backend, target=target, **kwargs)


def csvm_backend_exists(backend: Union[str, BackendType]) -> bool:
    """Whether the given implementation can run here (csvm.hpp:399-416)."""
    try:
        backend = BackendType.from_string(backend)
    except (InvalidParameterError, UnsupportedBackendError):
        return False
    if backend == BackendType.CUDA:
        return torch.cuda.is_available()
    return True


def list_available_backends() -> list:
    available = [BackendType.AUTOMATIC, BackendType.TORCH]
    if torch.cuda.is_available():
        available.append(BackendType.CUDA)
    return available


def list_available_target_platforms() -> list:
    platforms = [TargetPlatform.AUTOMATIC, TargetPlatform.CPU]
    if torch.cuda.is_available():
        platforms.append(TargetPlatform.GPU)
    return platforms
