"""plssvm_tpu_torch — the PyTorch and CUDA port of plssvm_tpu.

Binary and one-vs-all multiclass LS-SVM classification trained by
matrix-free Conjugate Gradient on one device: each CG iteration applies the
implicit kernel matrix through a Gram matvec (binary) or block matmat
(multiclass) written by hand in CUDA for NVIDIA Hopper (csrc/), with plain
PyTorch versions of the same functions for the CPU.  Predict also scores
one-vs-one (LIBSVM multiclass) model files.  The public API and the
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
    "csvm_backend_exists",
    "list_available_backends",
    "list_available_target_platforms",
    "VerbosityLevel",
    "set_verbosity",
    "get_verbosity",
    "global_tracker",
]
