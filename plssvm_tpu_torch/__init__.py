"""plssvm_tpu_torch — the PyTorch and CUDA port of plssvm_tpu.

Binary, one-vs-all and one-vs-one LS-SVM classification, LS-SVR and
one-class training by matrix-free Conjugate Gradient: each CG iteration applies the
implicit kernel matrix through a Gram matvec (binary) or block matmat
(multiclass) written by hand in CUDA for NVIDIA Hopper (csrc/), with plain
PyTorch versions of the same functions for the CPU.  Probability
calibration, cross-validation and robust refits run as host code around
the fits (probability.py, robust.py); compact models by Suykens pruning and
fixed-size Nystroem fits (sparse.py) and the sklearn facades SVC / SVR /
OneClassSVM (sklearn.py) as well.  The public API and the
file formats are plssvm_tpu's; plssvm_tpu (JAX) stays the reference this
package is tested against.  Importing the package builds no kernel.
"""

from .version import __version__
from .exceptions import (
    DataSetError,
    InvalidFileFormatError,
    InvalidParameterError,
    KernelLaunchError,
    ModelError,
    NotPortedError,
    NumericCheckError,
    PLSSVMError,
    UnsupportedBackendError,
    UnsupportedKernelTypeError,
)
from .parameter import (
    BackendType,
    ClassificationType,
    DefaultValue,
    FileFormatType,
    KernelFunctionType,
    Parameter,
    TargetPlatform,
)
from .data_set import DataSet, LabelMapper, Scaling
from .model import Model, model_from_numpy
from .csvm import (
    CSVM,
    csvm_backend_exists,
    list_available_backends,
    list_available_target_platforms,
    make_csvm,
)
from .kernel_functions import kernel_function
from .probability import (
    calibrate_model,
    calibrate_svr_noise,
    cross_validate,
    predict_probabilities,
)
from .one_class import fit_one_class, fit_one_class_multihost
from .robust import reweighted_fit
from .sklearn import SVC, SVR, OneClassSVM
from .sparse import (
    nystroem_fit,
    nystroem_fit_from_file,
    nystroem_fit_multihost,
    nystroem_fit_one_class,
    nystroem_fit_one_class_from_file,
    pruned_fit,
    pruned_fit_one_class,
)
from .utils.logger import VerbosityLevel, get_verbosity, set_verbosity
from .utils.tracker import global_tracker

__all__ = [
    "__version__",
    "PLSSVMError",
    "InvalidParameterError",
    "InvalidFileFormatError",
    "DataSetError",
    "ModelError",
    "KernelLaunchError",
    "NotPortedError",
    "NumericCheckError",
    "UnsupportedBackendError",
    "UnsupportedKernelTypeError",
    "BackendType",
    "ClassificationType",
    "DefaultValue",
    "FileFormatType",
    "KernelFunctionType",
    "Parameter",
    "TargetPlatform",
    "DataSet",
    "LabelMapper",
    "Scaling",
    "Model",
    "model_from_numpy",
    "CSVM",
    "make_csvm",
    "kernel_function",
    "calibrate_model",
    "calibrate_svr_noise",
    "cross_validate",
    "predict_probabilities",
    "fit_one_class",
    "fit_one_class_multihost",
    "reweighted_fit",
    "SVC",
    "SVR",
    "OneClassSVM",
    "pruned_fit",
    "pruned_fit_one_class",
    "nystroem_fit",
    "nystroem_fit_from_file",
    "nystroem_fit_multihost",
    "nystroem_fit_one_class",
    "nystroem_fit_one_class_from_file",
    "csvm_backend_exists",
    "list_available_backends",
    "list_available_target_platforms",
    "VerbosityLevel",
    "set_verbosity",
    "get_verbosity",
    "global_tracker",
]
