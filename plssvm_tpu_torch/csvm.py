"""The C-SVM front end: fit / predict / score on one PyTorch device.

Counterpart of plssvm_tpu/csvm.py (reference: include/plssvm/csvm.hpp:129-375
and include/plssvm/csvm_factory.hpp:123-171).  ``CSVM`` resolves its device
once, at construction, and creates every tensor there; nothing is moved
between devices behind the caller's back.  The backend picks the kernel
products: ``cuda``, the hand-written kernels (csrc/*.cu), or ``torch``,
their plain PyTorch versions on any device.

This package covers binary, one-vs-all and one-vs-one multiclass
classification, LS-SVR regression and one-class training (one_class.py) with
the implicit and the explicit CG solver (``solver``; ``automatic`` resolves
per fit as plssvm_tpu does, with the budget and the Gram crossover of this
device), for every kernel function (linear, polynomial, RBF,
sigmoid, laplacian, chi-squared), on one device or row-sharded over a list
of devices (``devices``, parallel/sharded.py; the batched one-vs-one solve
splits its machines over them instead), with plssvm_tpu's solver
extras (warm start, sample weights, the Jacobi preconditioner, CG-state
checkpoint/resume, ``debug`` guards), and predict with binary, one-vs-all,
one-vs-one (LIBSVM multiclass), regression (epsilon_svr) and one-class
model files; probability.py calibrates models and cross-validates around
``fit`` and ``predict_values``, robust.py refits LS-SVR with Hampel weights.
``fit_multihost`` trains over the processes of a ``torch.distributed`` job,
each parsing its window of the file (parallel/multihost.py).
"""

from __future__ import annotations

import functools
import os
import time
from typing import Optional, Union

import numpy as np
import torch

from .data_set import DataSet
from .exceptions import InvalidParameterError, UnsupportedBackendError
from .kernel_functions import DISTANCE_KERNELS
from .model import Model
from .ops.predict import calculate_w, predict_values as predict_values_op
from .parallel.sharded import (
    build_sharded_kernel_matrix,
    predict_values_sharded,
    solve_ls_svm_multi_sharded,
    solve_ls_svm_pairs_sharded,
    solve_ls_svm_sharded,
)
from .parameter import (
    BackendType,
    ClassificationType,
    KernelFunctionType,
    Parameter,
    TargetPlatform,
)
from .solver.cg import solve_ls_svm, solve_ls_svm_multi, solve_ls_svm_pairs
from .solver.explicit import (
    build_kernel_matrix,
    solve_ls_svm_explicit,
    solve_ls_svm_explicit_multi,
)
from .utils.logger import VerbosityLevel, log
from .utils.tracker import add_tracking_entry

_REAL_DTYPES = (np.dtype(np.float32), np.dtype(np.float64))

#: the environment variable that overrides the explicit solver's budget
#: (bytes), plssvm_tpu's PLSSVM_TPU_EXPLICIT_BUDGET
EXPLICIT_BUDGET_ENV = "PLSSVM_TPU_TORCH_EXPLICIT_BUDGET"
#: the explicit budget on the CPU: plssvm_tpu's default
CPU_EXPLICIT_BUDGET = 6 << 30
#: the (dept, columns) CG vectors a solve holds at once, at most (x, r, d,
#: the product, the targets, q, the Jacobi diagonal and the temporaries of
#: the rank-one update and the compensated sums), counted against the
#: explicit budget on a CUDA device
CG_VECTORS = 16
#: a CUDA device's memory that the context, cuBLAS's workspace and the
#: caching allocator's slack take, held out of the explicit budget
CUDA_CONTEXT_BYTES = 2 << 30
#: the feature count from which ``automatic`` takes the explicit solver for
#: a Gram kernel on a CUDA device, by tier ("f64": a float64 solve, every
#: tier), for a binary and a one-vs-all fit, None for never: the smallest d
#: of 16, 32, ..., 1024 from which the implicit product of an iteration
#: (kernel A, or C for C classes, on the operand copy the solve makes once)
#: takes longer than one read of the stored K plus a twentieth of the
#: build, for one-vs-all at every class count swept (3, 4 and 10), at 32768
#: rows on an H100 80GB HBM3 at 700 W (tools/bench_explicit.py --sweep
#: 32768; PERF.md).  "highest" runs on the tensor cores in three TF32
#: passes, whose product the stored K beats from d = 256 on
GRAM_CROSSOVER_CUDA = {"f32": (1024, 1024), "bf16": (1024, None), "highest": (256, 256),
                       "f64": (128, 128)}
#: the environment variable that overrides the batched one-vs-one solve's
#: budget (GiB), plssvm_tpu's PLSSVM_OAO_BATCH_BUDGET_GB
OAO_BATCH_BUDGET_ENV = "PLSSVM_TPU_TORCH_OAO_BATCH_BUDGET_GB"
#: the (P, m_pad, d) operand stack per device that ``oao_batch="auto"``
#: batches up to, GiB: plssvm_tpu's, on the CPU and on a CUDA device alike,
#: so that a fit selects as plssvm_tpu's does
OAO_BATCH_BUDGET_GB = 2.0


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


def _physical(device: torch.device) -> torch.device:
    """``device`` with its index: "cuda" is the current CUDA device."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _cached_bytes(data: Optional[DataSet], device: torch.device) -> int:
    """Bytes of the kernel matrix cached on ``data`` (one tensor, or the
    ring's row blocks) that lie on ``device``."""
    if data is None or data._k_cache is None:
        return 0
    K = data._k_cache[1]
    return sum(k.numel() * k.element_size() for k in (K if isinstance(K, list) else [K])
               if _physical(k.device) == device)


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

    ``preconditioner="jacobi"`` runs preconditioned CG; ``debug=True``
    checks the CG state for NaN/Inf and raises :class:`NumericCheckError`
    (plssvm_tpu raises ``checkify.JaxRuntimeError`` with the same message).

    ``oao_batch`` picks the one-vs-one training strategy: ``"batched"``
    solves all C(C-1)/2 pair machines as one batched CG (kernel O; with
    ``devices`` its machines split over them), ``"sequential"`` fits them
    one after another through ``fit``, ``"auto"`` batches when the
    per-device operand stack fits the budget (``_use_oao_batched``).
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
        debug: bool = False,
        oao_batch: str = "auto",
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
        # "jacobi": preconditioned CG with the diagonal of the implicit
        # matrix; the stop rule stays the reference's r.r
        self.preconditioner = preconditioner
        # NaN/Inf guards on the CG state (solver/cg.py), one host sync each
        self.debug = bool(debug)
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
        # the caller's choice; each fit resolves it (_use_explicit_solver)
        # and records the result in the "cg" / "solver" tracking entry
        self.solver = solver
        # one-vs-one training: "batched" (one batched CG of every pair
        # machine), "sequential" (each through fit), "auto" (batched where
        # the operand stack fits, _use_oao_batched)
        if oao_batch not in ("auto", "batched", "sequential"):
            raise InvalidParameterError(
                f"Unrecognized oao_batch '{oao_batch}' (must be 'auto', "
                "'batched' or 'sequential')!"
            )
        self.oao_batch = oao_batch

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
        checkpoint_interval: int = 1000,
    ) -> Model:
        """Solve the LS-SVM dual with CG and return the model.

        Defaults: ``epsilon = 1e-3`` (relative, squared residual),
        ``max_iter = num_data_points`` (reference: csvm.hpp:268-269).
        Data with more than two labels trains one-vs-all (``classification
        = "oaa"``, the default): the C binary systems share the implicit
        matrix and are solved together as one block CG (an extension; the
        reference rejects such data, data_set.hpp:443).  With ``devices``
        both run row-sharded (parallel/sharded.py).  ``classification =
        "oao"`` trains the C(C-1)/2 one-vs-one pair machines on their
        class-pair rows (``oao_batch``: as one batched CG, or each through
        this method) and stores them in LIBSVM's multiclass layout.  A
        regression data set (``DataSet(regression=True)``) trains LS-SVR:
        the binary solve on its continuous targets.

        The extras are plssvm_tpu's:

        - ``initial_model`` warm-starts CG from a previous fit's alpha, its
          rows re-aligned to ``data``'s order (model files store support
          vectors class-grouped); the stop target stays the cold start's,
          so a warm fit stops at the accuracy a cold one would;
        - ``sample_weight`` (one positive weight per point) makes point i's
          regularizer ``1/(C s_i)``: Suykens' weighted LS-SVM, LIBSVM's
          ``-wi`` per class;
        - ``checkpoint_path`` saves the CG state every
          ``checkpoint_interval`` iterations and resumes from a file that
          matches the problem (solver/checkpoint.py); the resumed fit
          equals the uninterrupted one, and the file goes when the fit
          ends.
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
        if checkpoint_path is not None and int(checkpoint_interval) < 1:
            raise InvalidParameterError(
                f"checkpoint_interval must be at least 1, but is "
                f"{checkpoint_interval}!"
            )
        classification = ClassificationType.from_string(classification)
        n_classes = data.num_different_labels
        multiclass = n_classes > 2
        if sample_weight is not None:
            sample_weight = np.asarray(sample_weight, dtype=np.float64)
            if sample_weight.shape != (data.num_data_points,):
                raise InvalidParameterError(
                    f"sample_weight must have one entry per data point "
                    f"({data.num_data_points}), but has shape "
                    f"{sample_weight.shape}!"
                )
            if not np.all(sample_weight > 0.0):
                raise InvalidParameterError(
                    "sample_weight entries must all be positive!"
                )
        oao = multiclass and classification == ClassificationType.OAO
        if initial_model is not None:
            self._check_initial_model(initial_model, data, checkpoint_path,
                                      multiclass, n_classes, oao)
        kind = self._params.kernel_type.value
        if kind == KernelFunctionType.CHI_SQUARED:
            # before the one-vs-one dispatch: the batched pairs solve goes
            # straight to the kernel, with no fit per machine
            _check_chi_squared_data(np.asarray(data.data), "training data")
        if oao:
            return self._fit_oao(
                data, epsilon=epsilon, max_iter=max_iter,
                checkpoint_path=checkpoint_path,
                checkpoint_interval=checkpoint_interval,
                sample_weight=sample_weight, initial_model=initial_model,
            )

        params = self._params.copy()
        if params.gamma.is_default():
            # gamma default = 1 / num_features (reference: csvm.hpp:304-307)
            params.gamma.value = 1.0 / data.num_features
        degree = params.degree.value
        start = time.perf_counter()

        # the kernels mask ragged edges: the system keeps its dept rows
        transform_start = time.perf_counter()
        X = self._staged(data)
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
        n_dev = len(self.devices[:dept]) if self.devices else 1
        use_explicit = self._use_explicit_solver(
            dept, d, kind, n_dev, n_classes if multiclass else 1, data)
        add_tracking_entry("cg", "solver", "cg_explicit" if use_explicit else "cg_implicit")

        solve_kw = dict(
            kind=kind, degree=degree, impl=self._impl(),
            scalars=self.scalar_precision, gram_precision=self.gram_precision,
            preconditioner=self.preconditioner, debug=self.debug,
        )
        if self.devices is not None:
            solve_kw["devices"] = self.devices
        if sample_weight is not None:
            solve_kw["weights"] = self._tensor(sample_weight[:dept])
            solve_kw["weight_last"] = float(sample_weight[-1])
        if initial_model is not None:
            alpha0 = self._warm_start_alpha(initial_model, data)
            solve_kw["x_init"] = self._tensor(alpha0[:dept])
        if multiclass:
            solve = solve_ls_svm_multi_sharded if self.devices else solve_ls_svm_multi
            y_last = y[-1]
        else:
            solve = solve_ls_svm_sharded if self.devices else solve_ls_svm
            y_last = float(data.y[-1])
        if use_explicit:
            # K is built once (or found in the data set's cache) and every
            # checkpoint segment solves against it
            K = self._build_explicit_k(data, X[:dept], params.resolved_gamma(d),
                                       params.coef0.value, kind, degree)
            if self.devices is not None:
                solve_kw["kernel_matrix"] = K
            else:
                solve = functools.partial(
                    solve_ls_svm_explicit_multi if multiclass else solve_ls_svm_explicit, K)
        solve_args = (
            X[:dept], X[-1], y[:dept], y_last, params.resolved_gamma(d),
            params.coef0.value, params.cost.value, epsilon,
        )
        if checkpoint_path is None:
            result = solve(*solve_args, max_iter, **solve_kw)
        else:
            result = self._fit_with_checkpointing(
                solve, solve_args, solve_kw, X, y, sample_weight, epsilon,
                max_iter, checkpoint_path, int(checkpoint_interval), multiclass,
            )
        if multiclass:
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

    # -- the explicit solver's selection and its kernel matrix --------------
    def _explicit_k_bytes(self, rows: int, cols: int) -> int:
        """Bytes of a (rows, cols) block of the explicit kernel matrix at
        the current tier (bfloat16 at "bf16", else the solve's type)."""
        itemsize = 2 if self.gram_precision == "bf16" else self.dtype.itemsize
        return rows * cols * itemsize

    def _explicit_budget(self, device: torch.device, dept: int, d: int,
                         columns: int, data: Optional[DataSet] = None, ranks: int = 1,
                         held: Optional[float] = None) -> int:
        """The bytes the explicit kernel matrix may take on ``device``.

        ``PLSSVM_TPU_TORCH_EXPLICIT_BUDGET`` (bytes) overrides it.  On the
        CPU it is plssvm_tpu's 6 GiB, so that a fit on the CPU resolves as
        plssvm_tpu's does.  On a CUDA device it is the device's memory less
        what this process's live tensors hold there (other data sets'
        cached matrices among them, but not the one cached on ``data``,
        which the fit reuses or frees before its build) and less what the
        solve holds beside K: X once more (a shard device's copy), the CG
        vectors (``columns`` of each), the build's and the product's
        workspace and the CUDA context's reserve.  Other processes on the
        card are not counted, but for a multi-process fit whose ``ranks``
        processes share the card (parallel/multihost.py): ``held`` is then
        their live tensors' bytes, and each takes its workspace and context.
        """
        env = os.environ.get(EXPLICIT_BUDGET_ENV)
        if env is not None:
            return int(env)
        if device.type != "cuda":
            return CPU_EXPLICIT_BUDGET
        from .solver.explicit import BUILD_WORKSPACE_BYTES

        itemsize = self.dtype.itemsize
        total = torch.cuda.get_device_properties(device).total_memory
        if held is None:
            held = torch.cuda.memory_allocated(device) - _cached_bytes(data, device)
        return int(total - held - (dept + 1) * d * itemsize
                   - CG_VECTORS * dept * columns * itemsize
                   - ranks * (BUILD_WORKSPACE_BYTES + CUDA_CONTEXT_BYTES))

    def _explicit_bytes_per_device(self, dept: int, n_dev: int) -> dict:
        """The explicit kernel matrix's bytes on each physical device: the
        whole (dept, dept) matrix on one device, or the ring's row blocks
        K_p = k(X_p, X) summed over the shards a device holds (four shards
        on one card hold all of K there)."""
        if n_dev == 1:
            return {_physical(self.device): self._explicit_k_bytes(dept, dept)}
        from .parallel.sharded import shard_bounds

        per_device: dict = {}
        for (lo, hi), dev in zip(shard_bounds(dept, n_dev), self.devices):
            dev = _physical(dev)
            per_device[dev] = per_device.get(dev, 0) + self._explicit_k_bytes(hi - lo, dept)
        return per_device

    def _gram_crossover(self, columns: int = 1) -> Optional[int]:
        """The feature count from which ``automatic`` takes the explicit
        solver for a Gram kernel with ``columns`` right-hand sides, None
        for never.  On a CUDA device the crossover measured on an H100
        (GRAM_CROSSOVER_CUDA, by the solve's type and tier, binary or
        one-vs-all); on the CPU plssvm_tpu's rule for its XLA backend,
        ``512 // scale`` with scale 2 at "bf16" (half the bytes a read of K
        takes)."""
        if self.device.type == "cuda":
            tier = "f64" if self.dtype == np.float64 else self.gram_precision
            return GRAM_CROSSOVER_CUDA[tier][0 if columns == 1 else 1]
        return 512 // (2 if self.gram_precision == "bf16" else 1)

    def _use_explicit_solver(self, dept: int, d: int, kind, n_dev: int = 1,
                             columns: int = 1, data: Optional[DataSet] = None,
                             needs=None) -> bool:
        """Resolve ``solver`` for a fit of ``dept`` rows and ``d`` features
        over ``n_dev`` shards (plssvm_tpu's ``_use_explicit_solver``).

        ``cg_implicit`` never; ``cg_explicit`` always, and raises
        :class:`InvalidParameterError` when K does not fit the budget on a
        device; ``automatic`` takes it when K fits and the kernel favours
        it: never for the linear kernel (its factored O(m d) product wins),
        always for the distance kernels (their pair work is paid once, at
        the build), and for the Gram kernels from ``_gram_crossover()``
        features on.  The budget is counted per physical device, whatever
        the list of shard devices repeats; ``data``, the fit's data set,
        frees its cached matrix for this one (``_explicit_budget``).
        ``needs`` (a multi-process fit's, parallel/multihost.py) gives per
        device ``(K bytes, the build's column block, budget)`` in place of
        this process's devices.
        """
        if self.solver == "cg_implicit":
            return False
        if needs is None:
            per_device = self._explicit_bytes_per_device(dept, n_dev)
            # the ring builds each K_p one column block at a time, and
            # holds the block beside K_p while it copies it in
            block = 0
            if n_dev > 1:
                from .parallel.sharded import shard_bounds

                rows = max(hi - lo for lo, hi in shard_bounds(dept, n_dev))
                block = self._explicit_k_bytes(rows, rows)
            needs = [(per_device[dev], block,
                      self._explicit_budget(dev, dept, d, columns, data))
                     for dev in per_device]
        fits = all(k_bytes + block <= budget for k_bytes, block, budget in needs)
        if self.solver == "cg_explicit":
            if not fits:
                k_bytes, _, budget = max(needs, key=lambda n: n[0] + n[1] - n[2])
                raise InvalidParameterError(
                    f"solver='cg_explicit' needs {int(k_bytes)} bytes per device "
                    f"for the {dept}x{dept} kernel matrix over {n_dev} "
                    f"device(s), over the {int(budget)}-byte budget "
                    f"({EXPLICIT_BUDGET_ENV}) — use gram_precision='bf16', "
                    "solver='automatic', or cg_implicit!"
                )
            return True
        if not fits or kind == KernelFunctionType.LINEAR:
            return False
        if kind in DISTANCE_KERNELS:
            return True
        crossover = self._gram_crossover(columns)
        return crossover is not None and d >= crossover

    def _k_cache_key(self, shape, gamma: float, coef0: float, kind, degree: int) -> tuple:
        """The key of the kernel matrix memoised on a DataSet.

        The cost C is absent: it enters the solve only through the
        diagonal, so a sweep over C reuses the matrix.  The device(s), the
        tier, the type and the backend (which decides the tier's operands)
        are in it.
        """
        devices = tuple(map(str, self.devices)) if self.devices else (str(self.device),)
        return (tuple(shape), float(gamma), float(coef0), kind, int(degree),
                self.gram_precision, str(self.dtype), self._impl(), devices)

    def _build_explicit_k(self, data: DataSet, X: torch.Tensor, gamma: float,
                          coef0: float, kind, degree: int):
        """The explicit kernel matrix of ``X`` (the dept rows), built once
        and timed (plssvm_tpu's ``_build_explicit_k``): one (dept, dept)
        tensor, or on the ring the row blocks K_p = k(X_p, X), each on its
        shard's device.  Memoised on ``data``: a second fit with the same
        key (a sweep over C, a warm-started refinement, every checkpoint
        segment) takes it from there and records a build time of 0.0."""
        key = self._k_cache_key(X.shape, gamma, coef0, kind, degree)
        if data._k_cache is not None and data._k_cache[0] == key:
            add_tracking_entry("cg", "kernel_matrix_build_time", 0.0)
            return data._k_cache[1]
        # the previous matrix goes before the next is built: the data set
        # holds the only reference
        data._k_cache = None
        start = time.perf_counter()
        kw = dict(kind=kind, degree=degree, precision=self.gram_precision,
                  impl=self._impl())
        if self.devices is not None:
            K = build_sharded_kernel_matrix(X, self.devices, gamma, coef0, **kw)
            shards = K
        else:
            K = build_kernel_matrix(X, gamma, coef0, **kw)
            shards = [K]
        for dev in {k.device for k in shards if k.device.type == "cuda"}:
            torch.cuda.synchronize(dev)
        build_ms = (time.perf_counter() - start) * 1000.0
        log(
            VerbosityLevel.FULL | VerbosityLevel.TIMING,
            "Assembled the explicit {}x{} kernel matrix ({}) in {} block(s) in {:.2f}ms.\n",
            X.shape[0], X.shape[0], str(shards[0].dtype), len(shards), build_ms,
        )
        add_tracking_entry("cg", "kernel_matrix_build_time", build_ms)
        data._k_cache = (key, K)
        return K

    def _check_initial_model(self, initial_model: Model, data: DataSet,
                             checkpoint_path, multiclass: bool, n_classes: int,
                             oao: bool = False) -> None:
        """plssvm_tpu's checks of a warm start's model against the data."""
        if checkpoint_path is not None:
            raise InvalidParameterError(
                "initial_model cannot be combined with CG-state "
                "checkpointing (the checkpoint already carries the "
                "solver state)!"
            )
        if initial_model.num_support_vectors != data.num_data_points:
            raise InvalidParameterError(
                f"initial_model has {initial_model.num_support_vectors} "
                f"support vectors but the data set has "
                f"{data.num_data_points} points!"
            )
        alpha0 = np.asarray(initial_model.alpha)
        if oao:
            if (initial_model.classification != ClassificationType.OAO
                    or alpha0.ndim != 2 or alpha0.shape[1] != n_classes - 1):
                raise InvalidParameterError(
                    "initial_model is not a one-vs-one model of "
                    f"{n_classes} classes!"
                )
        elif multiclass and (alpha0.ndim != 2 or alpha0.shape[1] != n_classes):
            raise InvalidParameterError(
                "initial_model is not a one-vs-all model of "
                f"{n_classes} classes!"
            )
        if not multiclass and alpha0.ndim != 1:
            raise InvalidParameterError("initial_model is not a binary model!")

    def _warm_start_alpha(self, initial_model: Model, data: DataSet) -> np.ndarray:
        """The warm-start alpha, re-aligned to ``data``'s row order
        (plssvm_tpu's ``_warm_start_alpha``).

        Model FILES store support vectors class-grouped (the writer keeps
        the within-class relative order), so a loaded model's alpha rows are
        a known permutation of the training file's rows: the k-th occurrence
        of class c in data order is the k-th row of the model's class-c
        block.  Misalignment never affects correctness (the warm start only
        sets CG's starting point) but destroys the benefit.  Loaded
        one-vs-all models may also carry an unsorted label header; their
        alpha columns follow the model's layout order and are permuted here
        to the mapper's sorted order the solver trains in.
        """
        alpha0 = np.asarray(initial_model.alpha, dtype=self.dtype)
        if data.is_regression or initial_model.is_regression:
            # continuous targets carry no class structure to realign by:
            # the warm start is used as it is (correct whatever the row
            # order; only the iterations saved depend on it)
            return alpha0
        m_labels = np.asarray(initial_model.data.labels)
        d_labels = np.asarray(data.labels)
        if not (
            m_labels.shape == d_labels.shape
            and bool(np.all(m_labels == d_labels))
        ):
            if sorted(map(str, m_labels.tolist())) != sorted(
                map(str, d_labels.tolist())
            ):
                raise InvalidParameterError(
                    "initial_model labels do not match the data set's "
                    "labels (same points required for a warm start)!"
                )
            aligned = np.zeros_like(alpha0)
            for lab in data.different_labels:  # per-label, order-free
                aligned[np.flatnonzero(d_labels == lab)] = alpha0[
                    np.flatnonzero(m_labels == lab)
                ]
            alpha0 = aligned
        if alpha0.ndim == 2:
            order = initial_model.class_order()
            target = list(data.different_labels)
            if order != target:
                perm = [order.index(lab) for lab in target]
                alpha0 = alpha0[:, perm]
        return alpha0

    # -- one-vs-one -----------------------------------------------------------
    def _staged(self, data: DataSet) -> torch.Tensor:
        """``data``'s rows on the device: gathered there from a once-staged
        parent operand when the data set is a one-vs-one pair machine's
        (``_device_rows = (X_aug, rows)``, set by ``_fit_oao``), else
        copied from the host."""
        device_rows = getattr(data, "_device_rows", None)
        if device_rows is not None and self.devices is None:
            X_aug, rows = device_rows
            return X_aug[rows]
        return self._tensor(data.data)

    def _with_zero_row(self, X: np.ndarray) -> torch.Tensor:
        """X (n, d) on the device with a trailing zero row: the parent
        operand a one-vs-one fit gathers each machine's rows from (index n
        pads a machine's block with zeros)."""
        return torch.nn.functional.pad(self._tensor(X), (0, 0, 0, 1))

    def _oao_warm_pair_alpha(self, initial_model: Model, data: DataSet, rows,
                             is_first, i: int, j: int) -> np.ndarray:
        """The (i, j) pair machine's warm-start alpha from a one-vs-one
        model (plssvm_tpu's ``_oao_warm_pair_alpha``).

        Inverts ``oao.scatter_pair_alphas``: a data row of class c holds
        its coefficient for the machine against class c' in column
        ``coef_column(c, c')``, indexed in the model's layout class order
        (the label header's for loaded files).  Where the model stores the
        pair with the other +1 side (its layout orders j before i), the
        solution is negated, as negating y negates the linear system's
        solution.  Alignment never affects correctness, only the
        iterations saved.
        """
        from . import oao

        aligned = getattr(initial_model, "_oao_warm_aligned", None)
        if aligned is None or aligned[0] is not data:
            sv_coef = np.asarray(initial_model.alpha, dtype=np.float64)
            m_labels = np.asarray(initial_model.data.labels)
            d_labels = np.asarray(data.labels)
            if not (m_labels.shape == d_labels.shape
                    and bool(np.all(m_labels == d_labels))):
                if sorted(map(str, m_labels.tolist())) != sorted(
                        map(str, d_labels.tolist())):
                    raise InvalidParameterError(
                        "initial_model labels do not match the data set's "
                        "labels (same points required for a warm start)!"
                    )
                # model files store the SVs class-grouped: the k-th
                # occurrence of class c in data order is the k-th row of the
                # model's class-c block (as in _warm_start_alpha)
                realigned = np.zeros_like(sv_coef)
                for lab in data.different_labels:
                    realigned[np.flatnonzero(d_labels == lab)] = sv_coef[
                        np.flatnonzero(m_labels == lab)]
                sv_coef = realigned
            aligned = (data, sv_coef, initial_model.class_order())
            initial_model._oao_warm_aligned = aligned
        _, sv_coef, order = aligned

        labels_sorted = list(data.different_labels)
        mi = order.index(labels_sorted[i])
        mj = order.index(labels_sorted[j])
        alpha0 = np.empty(len(rows), dtype=np.float64)
        alpha0[is_first] = sv_coef[rows[is_first], oao.coef_column(mi, mj)]
        alpha0[~is_first] = sv_coef[rows[~is_first], oao.coef_column(mj, mi)]
        return -alpha0 if mi > mj else alpha0

    def _fit_oao(self, data: DataSet, *, epsilon: float, max_iter: int,
                 checkpoint_path: Optional[str], checkpoint_interval: int,
                 sample_weight=None, initial_model: Optional[Model] = None) -> Model:
        """One-vs-one multiclass fit: C(C-1)/2 pairwise LS-SVM machines
        (plssvm_tpu's ``_fit_oao``).

        Machine (i, j) trains on the rows of classes i and j only, class i
        mapped to +1 (LIBSVM's convention), and the result is stored in
        LIBSVM's multiclass layout (oao.py): sv_coef (n, C-1) and one rho
        per machine in pair order.  ``_use_oao_batched`` decides between
        the batched solve (``_fit_oao_batched``) and this loop, in which
        each machine is a fit of its own through :meth:`fit`, so every path
        of a binary fit applies per machine (the explicit solver under
        ``automatic``, the ring with ``devices``, a checkpoint per machine
        at ``{checkpoint_path}.pair{i}-{j}``).  On one device X is staged
        there once, with a trailing zero row, and each machine gathers its
        rows from it.
        """
        from . import oao

        start = time.perf_counter()
        params = self._params.copy()
        if params.gamma.is_default():
            params.gamma.value = 1.0 / data.num_features

        C = data.num_different_labels
        idx = data.mapper.map_labels(np.asarray(data.labels), dtype=np.int64)
        X = np.asarray(data.data)
        n = X.shape[0]
        pairs = oao.class_pairs(C)
        rows_list = [np.flatnonzero((idx == i) | (idx == j)) for (i, j) in pairs]
        if self._use_oao_batched(pairs, rows_list, X, checkpoint_path):
            return self._fit_oao_batched(
                data, params, pairs, rows_list, idx, X, epsilon=epsilon,
                max_iter=max_iter, sample_weight=sample_weight,
                initial_model=initial_model, start=start)

        sv_coef = np.zeros((n, C - 1), dtype=self.dtype)
        rho = np.zeros(len(pairs), dtype=np.float64)
        iters_per_machine = []
        X_aug = self._with_zero_row(X) if self.devices is None else None
        for m, ((i, j), rows) in enumerate(zip(pairs, rows_list)):
            is_first = idx[rows] == i
            # class i is the +1 side: machine (i, j) votes i when f > 0
            y_pair = np.where(is_first, 1.0, -1.0)
            sub = DataSet(X[rows], y_pair)
            if X_aug is not None:
                sub._device_rows = (X_aug, torch.as_tensor(rows, device=self.device))
            warm_sub = None
            if initial_model is not None:
                alpha0 = self._oao_warm_pair_alpha(initial_model, data, rows, is_first,
                                                   i, j)
                warm_sub = Model(params, sub, alpha=alpha0.astype(self.dtype), rho=0.0)
            sub_model = self.fit(
                sub, epsilon=epsilon, max_iter=max_iter,
                checkpoint_path=(None if checkpoint_path is None
                                 else f"{checkpoint_path}.pair{i}-{j}"),
                checkpoint_interval=checkpoint_interval,
                sample_weight=None if sample_weight is None else sample_weight[rows],
                initial_model=warm_sub,
            )
            oao.scatter_pair_alphas(sv_coef, rows, is_first,
                                    np.asarray(sub_model.alpha, dtype=self.dtype), i, j)
            rho[m] = float(sub_model.rho)
            iters_per_machine.append(int(sub_model.n_iter or 0))
        return self._oao_model(params, data, sv_coef, rho, iters_per_machine, start,
                               "sequential")

    def _oao_model(self, params, data: DataSet, sv_coef, rho, iters_per_machine,
                   start: float, strategy: str) -> Model:
        """The one-vs-one model of a fit, its log lines and its tracking
        entries (``classification``, ``oao_strategy``,
        ``iterations_per_machine``)."""
        total_iters = int(sum(iters_per_machine))
        total_ms = (time.perf_counter() - start) * 1000.0
        if strategy == "batched":
            # a sequential fit's machines logged their own
            log(VerbosityLevel.LIBSVM, "optimization finished, #iter = {}\n", total_iters)
        log(
            VerbosityLevel.FULL | VerbosityLevel.TIMING,
            "Solved {} one-vs-one machines ({} classes) in {:.2f}ms "
            "({} CG iterations in total, {}).\n\n",
            len(rho), data.num_different_labels, total_ms, total_iters,
            "batched block CG" if strategy == "batched" else "one machine after another",
        )
        add_tracking_entry("cg", "classification", "oao")
        add_tracking_entry("cg", "oao_strategy", strategy)
        add_tracking_entry("cg", "iterations_per_machine", iters_per_machine)
        add_tracking_entry("cg", "total_runtime", total_ms)
        model = Model(params, data, alpha=sv_coef, rho=rho)
        model.classification = ClassificationType.OAO
        model.n_iter = total_iters
        #: per-pair-machine CG iterations, in LIBSVM's machine order
        model.n_iter_per_machine = iters_per_machine
        return model

    def _oao_batch_budget(self) -> int:
        """Bytes of the (P_local, m_pad, d) operand stack per device that
        ``oao_batch="auto"`` batches up to: ``OAO_BATCH_BUDGET_GB`` GiB, or
        ``PLSSVM_TPU_TORCH_OAO_BATCH_BUDGET_GB``."""
        gb = float(os.environ.get(OAO_BATCH_BUDGET_ENV, OAO_BATCH_BUDGET_GB))
        return int(gb * (1 << 30))

    def _use_oao_batched(self, pairs, rows_list, X, checkpoint_path) -> bool:
        """Whether this one-vs-one fit runs the batched pairs solve
        (plssvm_tpu's ``_use_oao_batched``).

        ``oao_batch="batched"`` forces it and refuses a checkpoint (the
        batched solve has no per-machine state file); ``"sequential"``
        never; ``"auto"`` batches when there are at least two machines, no
        checkpoint is asked for and the per-device stack of the machines'
        rows, (ceil(P / devices), m_pad, d) with m_pad the largest
        machine's dept, fits the budget.  The budget counts the stack
        alone, as plssvm_tpu's does: kernel O's FFMA walk adds a workspace
        of under 17 (m_pad + 16 x 128) values a machine
        (csrc/pairs.cu ``plssvm_pairs_workspace_elements``): 17 / d of the
        stack plus a few MB.
        """
        if self.oao_batch == "sequential":
            return False
        if self.oao_batch == "batched":
            if checkpoint_path is not None:
                raise InvalidParameterError(
                    "oao_batch='batched' cannot checkpoint per machine — "
                    "use oao_batch='sequential' with checkpoint_path!"
                )
            return True
        P = len(pairs)
        if checkpoint_path is not None or P < 2:
            return False
        n_dev = 1 if self.devices is None else len(self.devices)
        m_pad = max(len(r) - 1 for r in rows_list)
        stack_bytes = -(-P // n_dev) * m_pad * X.shape[1] * self.dtype.itemsize
        return stack_bytes <= self._oao_batch_budget()

    def _fit_oao_batched(self, data, params, pairs, rows_list, idx, X, *,
                         epsilon, max_iter, sample_weight, initial_model,
                         start) -> Model:
        """All C(C-1)/2 pair machines as one batched CG (plssvm_tpu's
        ``_fit_oao_batched``) through :meth:`_solve_pair_machines`, each
        machine capped at ``max_iter`` (``fit`` resolved None to the
        parent's point count, as the sequential path's sub-fits receive
        it)."""
        from . import oao

        C = data.num_different_labels
        first_list = [idx[rows] == i for (i, _), rows in zip(pairs, rows_list)]
        x_init_list = None
        if initial_model is not None:
            x_init_list = [self._oao_warm_pair_alpha(initial_model, data, rows, first, i, j)
                           for ((i, j), rows, first) in zip(pairs, rows_list, first_list)]
        alphas, rho, iters_per_machine, block = self._solve_pair_machines(
            params, X, rows_list, first_list, epsilon=epsilon,
            max_iter_b=[int(max_iter)] * len(pairs), sample_weight=sample_weight,
            x_init_list=x_init_list)
        sv_coef = np.zeros((X.shape[0], C - 1), dtype=self.dtype)
        for ((i, j), rows, first, alpha_p) in zip(pairs, rows_list, first_list, alphas):
            oao.scatter_pair_alphas(sv_coef, rows, first, alpha_p, i, j)
        # the loop's iterations (every machine's products in one launch each)
        add_tracking_entry("cg", "block_iterations", block)
        return self._oao_model(params, data, sv_coef, rho, iters_per_machine, start,
                               "batched")

    def _solve_pair_machines(self, params, X, rows_list, first_list, *, epsilon,
                             max_iter_b, sample_weight=None, x_init_list=None):
        """Binary machines on row subsets of X (n, d) as one batched CG:
        machine p trains on the rows ``rows_list[p]``, +1 where
        ``first_list[p]`` and -1 elsewhere, its last row folded out, capped
        at ``max_iter_b[p]`` iterations, warm-started from
        ``x_init_list[p]`` (its weights over those rows) where given.  The
        one-vs-one fit's machines, and the folds of their cross-validation
        (probability.py).

        X is staged on the device once, with a trailing zero row; each
        machine's rows are gathered there into a (P, m_pad, d) stack, m_pad
        the largest machine's rows less its folded-out one (no further
        padding: kernel O masks each machine's edge), and
        ``solve_ls_svm_pairs`` iterates every machine at once, each freezing
        at its own stop rule or cap, every product at the fit's
        ``gram_precision`` (kernel O's tensor-core walks on the card; the
        CPU's plain version ignores the tier).  With ``devices`` the
        machines split over them in contiguous groups
        (``solve_ls_svm_pairs_sharded``).

        Returns ``(alphas, rho, iterations_per_machine, block_iterations)``,
        ``alphas[p]`` machine p's weights over ``rows_list[p]`` and ``rho``
        (P,) float64.
        """
        n, d = X.shape
        P = len(rows_list)
        depts = np.asarray([len(r) - 1 for r in rows_list])
        m_pad = int(depts.max())

        zero_row = n
        idx_b = np.full((P, m_pad), zero_row, dtype=np.int64)
        yb = np.zeros((P, m_pad), dtype=self.dtype)
        maskb = np.zeros((P, m_pad), dtype=self.dtype)
        y_last_b = np.zeros((P,), dtype=self.dtype)
        last_idx = np.full((P,), zero_row, dtype=np.int64)
        max_iter_b = np.asarray(max_iter_b, dtype=np.int64)
        weights_b = weight_last_b = x_init_b = None
        if sample_weight is not None:
            weights_b = np.ones((P, m_pad), dtype=self.dtype)
            weight_last_b = np.ones((P,), dtype=self.dtype)
        if x_init_list is not None:
            x_init_b = np.zeros((P, m_pad), dtype=self.dtype)
        for p, (rows, first) in enumerate(zip(rows_list, first_list)):
            dept = depts[p]
            # the first side is the +1 side: machine (i, j) votes i when f > 0
            y_pair = np.where(first, 1.0, -1.0)
            idx_b[p, :dept] = rows[:dept]
            yb[p, :dept] = y_pair[:dept]
            maskb[p, :dept] = 1.0
            y_last_b[p] = y_pair[dept]
            last_idx[p] = rows[dept]
            if sample_weight is not None:
                weights_b[p, :dept] = sample_weight[rows[:dept]]
                weight_last_b[p] = sample_weight[rows[dept]]
            if x_init_list is not None:
                x_init_b[p, :dept] = x_init_list[p][:dept]

        X_aug = self._with_zero_row(X)

        def dev(a):
            return None if a is None else torch.as_tensor(a, device=self.device)

        args = (dev(yb), dev(y_last_b), dev(maskb), params.resolved_gamma(d),
                params.coef0.value, params.cost.value, epsilon, dev(max_iter_b))
        solve_kw = dict(kind=params.kernel_type.value, degree=params.degree.value,
                        impl=self._impl(), scalars=self.scalar_precision,
                        gram_precision=self.gram_precision,
                        preconditioner=self.preconditioner, debug=self.debug,
                        x_init=dev(x_init_b), weights=dev(weights_b),
                        weight_last=dev(weight_last_b))
        if self.devices is not None:
            result = solve_ls_svm_pairs_sharded(
                X_aug, dev(idx_b), dev(last_idx), *args, devices=self.devices, **solve_kw)
        else:
            result = solve_ls_svm_pairs(
                X_aug[dev(idx_b)], X_aug[dev(last_idx)], *args, **solve_kw)

        x_sol = result.x.cpu().numpy()
        alpha_last = result.alpha_last.cpu().numpy()
        alphas = [np.concatenate([x_sol[p, :depts[p]], [alpha_last[p]]]).astype(self.dtype)
                  for p in range(P)]
        return (alphas, result.rho.cpu().numpy().astype(np.float64),
                [int(v) for v in result.iterations_per_pair.cpu().tolist()],
                int(result.iterations))

    def _params_repr_for_fingerprint(self, sample_weight) -> str:
        """The parameters in the checkpoint fingerprint, with a digest of
        the sample weights: a differently weighted run solves another
        system and must never resume this one's checkpoint."""
        rep = repr(self._params)
        if sample_weight is not None:
            from .solver.checkpoint import weights_digest_suffix

            rep += weights_digest_suffix(sample_weight)
        return rep

    def _fit_with_checkpointing(self, solve, solve_args, solve_kw, X, y,
                                sample_weight, epsilon, max_iter: int,
                                checkpoint_path: str, checkpoint_interval: int,
                                multi: bool):
        """Run CG in segments of ``checkpoint_interval`` iterations, saving
        the state between them (plssvm_tpu's ``_fit_with_checkpointing`` and
        ``_fit_with_checkpointing_multi``; on the ring as on one device,
        since the ring's CG state lies whole on its first device).  A file
        that matches the problem is resumed from; the file goes when the
        fit ends (``solver/checkpoint.py::run_segments``)."""
        from .solver.checkpoint import problem_fingerprint, run_segments

        def segment(seg_end, init_state):
            return solve(*solve_args, seg_end, init_state=init_state, **solve_kw)

        def place(ckpt):
            state = tuple(
                torch.as_tensor(np.asarray(a, dtype=self.dtype), device=self.device)
                for a in (ckpt.x, ckpt.r, ckpt.d, ckpt.delta, ckpt.delta0)
            ) + (ckpt.iteration,)
            if multi:
                state += (torch.as_tensor(ckpt.itpc, dtype=torch.int64, device=self.device),)
            return state

        fingerprint = problem_fingerprint(
            X, y, self._params_repr_for_fingerprint(sample_weight), epsilon
        )
        return run_segments(segment, place, fingerprint=fingerprint, epsilon=epsilon,
                            max_iter=max_iter, path=checkpoint_path,
                            interval=checkpoint_interval, multi=multi,
                            label="block CG" if multi else "CG")

    # -- predict ------------------------------------------------------------
    def predict_values(self, model: Model, data: DataSet) -> np.ndarray:
        """Decision values f(x) = sum_i alpha_i k(sv_i, x) - rho.

        reference: csvm.hpp:325-343 + gpu_csvm.hpp:656-730.

        Binary, regression and one-class models return shape (n_pred,);
        one-vs-all models (n_pred, C), one decision column per class;
        one-vs-one models
        (n_pred, C(C-1)/2), one column per pair machine in LIBSVM order
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

    def fit_multihost(
        self,
        filename: str,
        *,
        epsilon: float = 0.001,
        max_iter: Optional[int] = None,
        label_type=None,
        checkpoint_path: Optional[str] = None,
        checkpoint_interval: int = 1000,
        classification: Union[str, ClassificationType] = ClassificationType.OAA,
        regression: bool = False,
        sample_weight=None,
        initial_model: Optional[Model] = None,
    ) -> Model:
        """A fit of ``filename`` (on storage every process reads) over the
        processes of a ``torch.distributed`` job, one rank a process on
        this CSVM's device: each parses only its window of rows, and the CG
        solve runs on the ring of ranks (parallel/multihost.py).  Every
        rank returns the same model; at one process it is
        ``fit(DataSet(filename))`` up to the order of its sums.

        ``sample_weight`` (one entry per file row), ``initial_model`` (a
        previous fit on the same file, re-aligned as in :meth:`fit`) and
        ``checkpoint_path`` (on storage every process reads; rank 0 writes
        it) as in :meth:`fit`.  One-vs-one is refused, as plssvm_tpu
        refuses it: its pair machines train on row subsets that defeat the
        window ingest.
        """
        from .parallel.multihost import fit_multihost as _fit_multihost

        if ClassificationType.from_string(classification) == ClassificationType.OAO:
            raise InvalidParameterError(
                "classification='oao' is not supported on the multi-host "
                "path (the pair machines train on row subsets that defeat "
                "the per-host window ingest) — use the default 'oaa'!"
            )
        if epsilon <= 0.0:
            raise InvalidParameterError(
                f"epsilon must be greater than 0.0, but is {epsilon}!"
            )
        if max_iter is not None and max_iter <= 0:
            raise InvalidParameterError(
                f"max_iter must be greater than 0, but is {max_iter}!"
            )
        if checkpoint_path is not None and int(checkpoint_interval) < 1:
            raise InvalidParameterError(
                f"checkpoint_interval must be at least 1, but is "
                f"{checkpoint_interval}!"
            )
        if initial_model is not None and checkpoint_path is not None:
            raise InvalidParameterError(
                "initial_model cannot be combined with CG-state "
                "checkpointing (the checkpoint already carries the "
                "solver state)!"
            )
        return _fit_multihost(
            self, filename, epsilon=epsilon, max_iter=max_iter,
            label_type=label_type, checkpoint_path=checkpoint_path,
            checkpoint_interval=checkpoint_interval, regression=regression,
            sample_weight=sample_weight, initial_model=initial_model,
        )

    def predict(self, model: Model, data: DataSet) -> np.ndarray:
        """Predicted labels mapped back to the original label type.

        Binary: sign(f), with sign(0) = -1 like the reference
        (operators.hpp:179-181).  Multiclass: argmax over the C one-vs-all
        decision columns, or pairwise voting for one-vs-one models
        (LIBSVM's svm_predict semantics, :func:`plssvm_tpu_torch.oao.vote`).
        Regression (LS-SVR): the decision values themselves.  One-class:
        +1 (inlier) where f > 0, else -1 (outlier), LIBSVM's svm_predict
        for ``-s 2`` models.
        """
        values = self.predict_values(model, data)
        if model.is_regression:
            return values
        if model.is_one_class:
            return np.where(values > 0.0, 1, -1).astype(np.int64)
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
        """Classification accuracy (reference: csvm.hpp:345-375); for a
        regression model the coefficient of determination R^2 over the data
        set's continuous targets (plssvm_tpu's, sklearn's ``SVR.score``)."""
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
        if model.is_regression:
            targets = np.asarray(data.labels, dtype=np.float64)
            values = np.asarray(self.predict_values(model, data), dtype=np.float64)
            ss_res = float(np.sum((targets - values) ** 2))
            ss_tot = float(np.sum((targets - targets.mean()) ** 2))
            if ss_tot == 0.0:
                # sklearn's r2_score rule for constant targets
                return 1.0 if ss_res == 0.0 else 0.0
            return 1.0 - ss_res / ss_tot
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
