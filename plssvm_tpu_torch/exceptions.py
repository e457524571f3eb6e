"""Exception hierarchy for plssvm_tpu_torch (the same classes as plssvm_tpu).

Mirrors the error taxonomy of the reference implementation
(reference: include/plssvm/exceptions/exceptions.hpp:29-140) so that callers
can catch the same classes of failure.  Python's traceback machinery replaces
the hand-rolled ``source_location`` of the reference.
"""

from __future__ import annotations


class PLSSVMError(RuntimeError):
    """Base class of all plssvm_tpu_torch exceptions.

    reference: include/plssvm/exceptions/exceptions.hpp:29 (plssvm::exception)
    """


class InvalidParameterError(PLSSVMError):
    """An invalid hyperparameter value was supplied.

    reference: exceptions.hpp (invalid_parameter_exception)
    """


class FileNotFoundError_(PLSSVMError):
    """A data/model/scaling file could not be opened.

    reference: exceptions.hpp (file_not_found_exception)
    """


class InvalidFileFormatError(PLSSVMError):
    """A data/model/scaling file violates its format specification.

    reference: exceptions.hpp (invalid_file_format_exception)
    """


class DataSetError(PLSSVMError):
    """Errors concerning :class:`plssvm_tpu_torch.data_set.DataSet` usage.

    reference: exceptions.hpp (data_set_exception)
    """


class ModelError(PLSSVMError):
    """Errors concerning :class:`plssvm_tpu_torch.model.Model` usage."""


class UnsupportedBackendError(PLSSVMError):
    """The requested compute implementation is unavailable.

    reference: exceptions.hpp (unsupported_backend_exception)
    """


class UnsupportedKernelTypeError(PLSSVMError):
    """The requested kernel function is unknown.

    reference: exceptions.hpp (unsupported_kernel_type_exception)
    """


class KernelLaunchError(PLSSVMError):
    """A device kernel failed to build or launch."""


class NotPortedError(PLSSVMError, NotImplementedError):
    """A feature of plssvm_tpu that this package does not carry yet.

    The message names the ROADMAP item that ports it.
    """


class NumericCheckError(PLSSVMError):
    """A NaN/Inf guard of a ``debug=True`` solve failed.

    plssvm_tpu raises ``checkify.JaxRuntimeError`` here; this carries the
    same message, with the iteration filled in.
    """
