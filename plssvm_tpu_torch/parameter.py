"""SVM hyperparameters, enums, and default-value tracking.

Re-design of the reference's parameter machinery:

- ``KernelFunctionType`` / ``FileFormatType`` / ``TargetPlatform`` /
  ``BackendType`` enums (reference: include/plssvm/kernel_function_types.hpp:31-38,
  backend_types.hpp:30-43, target_platforms.hpp:25-35).
- ``DefaultValue`` tracks whether a value was user-set or defaulted; this drives
  the "only override non-defaults" merge logic and the model-file validation
  (e.g. a linear-kernel model file must not carry an explicit gamma)
  (reference: include/plssvm/default_value.hpp:37-62,
  include/plssvm/detail/io/libsvm_model_parsing.hpp:201-224).
- ``Parameter`` bundles kernel_type, degree, gamma, coef0, cost
  (reference: include/plssvm/parameter.hpp:105-266).

The reference uses the igor named-argument library; Python keyword arguments
replace it 1:1.
"""

from __future__ import annotations

import enum
from typing import Generic, Optional, TypeVar, Union

from .exceptions import InvalidParameterError, UnsupportedKernelTypeError

T = TypeVar("T")


class KernelFunctionType(enum.IntEnum):
    """The implemented kernel functions.

    reference: include/plssvm/kernel_function_types.hpp:31-38 (linear,
    polynomial, rbf).  SIGMOID/LAPLACIAN/CHI_SQUARED are extensions matching
    upstream PLSSVM v3's kernel set (the same indices LIBSVM/PLSSVM use);
    this reference snapshot predates them.
    """

    #: linear kernel: u'*v
    LINEAR = 0
    #: polynomial kernel: (gamma*u'*v + coef0)^degree
    POLYNOMIAL = 1
    #: radial basis function kernel: exp(-gamma*|u-v|^2)
    RBF = 2
    #: sigmoid kernel: tanh(gamma*u'*v + coef0) — extension
    SIGMOID = 3
    #: laplacian kernel: exp(-gamma*|u-v|_1) — extension
    LAPLACIAN = 4
    #: chi-squared kernel: exp(-gamma*sum_i (u_i-v_i)^2/(u_i+v_i)) — extension
    #: (requires non-negative data)
    CHI_SQUARED = 5

    def __str__(self) -> str:  # round-trips through from_string
        return self.name.lower()

    @property
    def math_string(self) -> str:
        """Math representation used in help/log output.

        reference: kernel_function_types.hpp (kernel_function_type_to_math_string)
        """
        return {
            KernelFunctionType.LINEAR: "u'*v",
            KernelFunctionType.POLYNOMIAL: "(gamma*u'*v+coef0)^degree",
            KernelFunctionType.RBF: "exp(-gamma*|u-v|^2)",
            KernelFunctionType.SIGMOID: "tanh(gamma*u'*v+coef0)",
            KernelFunctionType.LAPLACIAN: "exp(-gamma*|u-v|_1)",
            KernelFunctionType.CHI_SQUARED:
                "exp(-gamma*sum_i((x[i]-y[i])^2/(x[i]+y[i])))",
        }[self]

    @classmethod
    def from_string(cls, value: Union[str, int, "KernelFunctionType"]) -> "KernelFunctionType":
        if isinstance(value, cls):
            return value
        if isinstance(value, int) or (isinstance(value, str) and value.strip().isdigit()):
            iv = int(value)
            try:
                return cls(iv)
            except ValueError:
                raise UnsupportedKernelTypeError(f"Invalid kernel function {iv} given!") from None
        s = str(value).strip().lower()
        aliases = {
            "linear": cls.LINEAR,
            "polynomial": cls.POLYNOMIAL,
            "poly": cls.POLYNOMIAL,
            "rbf": cls.RBF,
            "sigmoid": cls.SIGMOID,
            "laplacian": cls.LAPLACIAN,
            "chi_squared": cls.CHI_SQUARED,
            "chi-squared": cls.CHI_SQUARED,
        }
        if s not in aliases:
            raise UnsupportedKernelTypeError(f"Unrecognized kernel type '{value}'!")
        return aliases[s]


class FileFormatType(enum.Enum):
    """Supported data file formats (reference: include/plssvm/file_format_types.hpp)."""

    LIBSVM = "libsvm"
    ARFF = "arff"

    def __str__(self) -> str:
        return self.value

    @classmethod
    def from_string(cls, value: Union[str, "FileFormatType"]) -> "FileFormatType":
        if isinstance(value, cls):
            return value
        s = str(value).strip().lower()
        for member in cls:
            if member.value == s:
                return member
        raise InvalidParameterError(f"Unrecognized file format type '{value}'!")


class BackendType(enum.Enum):
    """Compute implementations.

    The reference dispatches between five vendor backends
    (reference: include/plssvm/backend_types.hpp:30-43); here two
    implementations of the Gram matvecs remain: the plain PyTorch versions,
    which run on any device, and the hand-written CUDA kernels.
    """

    AUTOMATIC = "automatic"
    #: plain PyTorch Gram matvecs (ops/matvec.py) on the CSVM's device —
    #: plays the role of the reference's always-available OpenMP backend.
    TORCH = "torch"
    #: the hand-written CUDA kernels (ops/gram_matvec.py, csrc/).
    CUDA = "cuda"

    def __str__(self) -> str:
        return self.value

    @classmethod
    def from_string(cls, value: Union[str, "BackendType"]) -> "BackendType":
        if isinstance(value, cls):
            return value
        s = str(value).strip().lower()
        # accept the reference's other backend names for CLI compatibility
        legacy = {"openmp": cls.TORCH, "hip": cls.AUTOMATIC,
                  "opencl": cls.AUTOMATIC, "sycl": cls.AUTOMATIC}
        for member in cls:
            if member.value == s:
                return member
        if s in legacy:
            return legacy[s]
        raise InvalidParameterError(f"Unrecognized backend type '{value}'!")


class TargetPlatform(enum.Enum):
    """Target hardware platform (reference: include/plssvm/target_platforms.hpp:25-35)."""

    AUTOMATIC = "automatic"
    CPU = "cpu"
    TPU = "tpu"
    GPU = "gpu"

    def __str__(self) -> str:
        return self.value

    @classmethod
    def from_string(cls, value: Union[str, "TargetPlatform"]) -> "TargetPlatform":
        if isinstance(value, cls):
            return value
        s = str(value).strip().lower()
        legacy = {"gpu_nvidia": cls.GPU, "gpu_amd": cls.GPU, "gpu_intel": cls.GPU}
        for member in cls:
            if member.value == s:
                return member
        if s in legacy:
            return legacy[s]
        raise InvalidParameterError(f"Unrecognized target platform '{value}'!")


class ClassificationType(enum.Enum):
    """Multiclass decomposition strategy (EXTENSION — the bundled reference
    is binary-only, data_set.hpp:443; upstream PLSSVM v3 added the same
    ``oaa``/``oao`` choice).

    - ``OAA`` (one-vs-all): C binary machines, class c vs the rest, solved
      TOGETHER as one block CG sharing the Gram work (solver/cg.py).
    - ``OAO`` (one-vs-one): C(C-1)/2 pairwise machines on class-pair row
      subsets, stored in the standard LIBSVM multiclass model format
      (C(C-1)/2 rho values, C-1 coefficient columns per SV) — model files
      interoperate with LIBSVM's own ``svm-train`` output.
    """

    OAA = "oaa"
    OAO = "oao"

    def __str__(self) -> str:
        return self.value

    @classmethod
    def from_string(
        cls, value: Union[str, "ClassificationType"]
    ) -> "ClassificationType":
        if isinstance(value, cls):
            return value
        s = str(value).strip().lower()
        aliases = {
            "oaa": cls.OAA, "one_vs_all": cls.OAA, "one-vs-all": cls.OAA,
            "ova": cls.OAA, "ovr": cls.OAA,
            "oao": cls.OAO, "one_vs_one": cls.OAO, "one-vs-one": cls.OAO,
            "ovo": cls.OAO,
        }
        if s not in aliases:
            raise InvalidParameterError(
                f"Unrecognized classification type '{value}'!"
            )
        return aliases[s]


class DefaultValue(Generic[T]):
    """A value that knows whether it is still the default.

    reference: include/plssvm/default_value.hpp:37-62 (default_init / default_value)
    """

    __slots__ = ("_default", "_value", "_is_default")

    def __init__(self, default: T):
        self._default = default
        self._value = default
        self._is_default = True

    @property
    def value(self) -> T:
        return self._value

    @value.setter
    def value(self, new_value: T) -> None:
        self._value = new_value
        self._is_default = False

    def is_default(self) -> bool:
        return self._is_default

    def get_default(self) -> T:
        return self._default

    def reset(self) -> None:
        self._value = self._default
        self._is_default = True

    def copy(self) -> "DefaultValue[T]":
        dv: DefaultValue[T] = DefaultValue(self._default)
        dv._value = self._value
        dv._is_default = self._is_default
        return dv

    def __repr__(self) -> str:
        return f"DefaultValue({self._value!r}, is_default={self._is_default})"

    def __eq__(self, other: object) -> bool:
        if isinstance(other, DefaultValue):
            return self._value == other._value and self._is_default == other._is_default
        return self._value == other

    def __hash__(self) -> int:
        return hash((self._value, self._is_default))


# Default hyperparameter values (reference: include/plssvm/parameter.hpp:157-165)
DEFAULT_KERNEL_TYPE = KernelFunctionType.LINEAR
DEFAULT_DEGREE = 3
DEFAULT_GAMMA = 0.0  # sentinel: real default is 1/num_features, set at fit time
DEFAULT_COEF0 = 0.0
DEFAULT_COST = 1.0


class Parameter:
    """The SVM hyperparameters with is-default tracking.

    reference: include/plssvm/parameter.hpp:105-266 (detail::parameter<T>),
    named-argument construction parameter.hpp:35-51.
    """

    __slots__ = ("kernel_type", "degree", "gamma", "coef0", "cost")

    def __init__(self, **kwargs):
        self.kernel_type: DefaultValue[KernelFunctionType] = DefaultValue(DEFAULT_KERNEL_TYPE)
        self.degree: DefaultValue[int] = DefaultValue(DEFAULT_DEGREE)
        self.gamma: DefaultValue[float] = DefaultValue(DEFAULT_GAMMA)
        self.coef0: DefaultValue[float] = DefaultValue(DEFAULT_COEF0)
        self.cost: DefaultValue[float] = DefaultValue(DEFAULT_COST)
        self.update(**kwargs)

    def update(self, **kwargs) -> None:
        """Set hyperparameters by keyword, marking them user-set."""
        for key, value in kwargs.items():
            if value is None:
                continue
            if key == "kernel_type":
                self.kernel_type.value = KernelFunctionType.from_string(value)
            elif key == "degree":
                self.degree.value = int(value)
            elif key == "gamma":
                self.gamma.value = float(value)
            elif key == "coef0":
                self.coef0.value = float(value)
            elif key == "cost":
                self.cost.value = float(value)
            else:
                raise InvalidParameterError(f"Unknown named parameter '{key}'!")

    def merge_non_defaults(self, other: "Parameter") -> None:
        """Override our values with the user-set (non-default) values of ``other``.

        reference: include/plssvm/csvm.hpp:243-257 (set_params)
        """
        for name in self.__slots__:
            theirs: DefaultValue = getattr(other, name)
            if not theirs.is_default():
                getattr(self, name).value = theirs.value

    def copy(self) -> "Parameter":
        p = Parameter.__new__(Parameter)
        for name in self.__slots__:
            object.__setattr__(p, name, getattr(self, name).copy())
        return p

    def equivalent(self, other: "Parameter") -> bool:
        """Kernel-aware equality: only compares parameters the kernel uses.

        reference: include/plssvm/parameter.hpp:191-207 (equivalent)
        """
        if self.kernel_type.value != other.kernel_type.value:
            return False
        kt = self.kernel_type.value
        if kt == KernelFunctionType.LINEAR:
            checks = ["cost"]
        elif kt == KernelFunctionType.POLYNOMIAL:
            checks = ["degree", "gamma", "coef0", "cost"]
        elif kt == KernelFunctionType.SIGMOID:
            checks = ["gamma", "coef0", "cost"]
        else:  # RBF / LAPLACIAN / CHI_SQUARED
            checks = ["gamma", "cost"]
        return all(getattr(self, n).value == getattr(other, n).value for n in checks)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Parameter):
            return NotImplemented
        return all(
            getattr(self, n).value == getattr(other, n).value for n in self.__slots__
        )

    def __hash__(self) -> int:
        return hash(tuple(getattr(self, n).value for n in self.__slots__))

    def __repr__(self) -> str:
        fields = ", ".join(f"{n}={getattr(self, n).value!r}" for n in self.__slots__)
        return f"Parameter({fields})"

    def sanity_check(self) -> None:
        """Validate the parameter combination.

        reference: include/plssvm/csvm.hpp:377-390 (sanity_check_parameter)
        """
        if not isinstance(self.kernel_type.value, KernelFunctionType):
            raise InvalidParameterError(
                f"Invalid kernel function {self.kernel_type.value} given!"
            )
        kt = self.kernel_type.value
        if (
            kt != KernelFunctionType.LINEAR
            and not self.gamma.is_default()
            and self.gamma.value <= 0.0
        ):
            raise InvalidParameterError(
                f"gamma must be greater than 0.0, but is {self.gamma.value}!"
            )
        if self.cost.value <= 0.0:
            # LIBSVM's svm-train rejects C <= 0 up front; here C = 0
            # would divide by zero in the 1/C regularizer and a negative
            # C yields an indefinite system CG silently "solves"
            raise InvalidParameterError(
                f"cost must be greater than 0.0, but is {self.cost.value}!"
            )

    def resolved_gamma(self, num_features: int) -> float:
        """gamma, defaulting to 1/num_features (reference: csvm.hpp:304-307)."""
        if self.gamma.is_default():
            return 1.0 / float(num_features)
        return self.gamma.value


VerbosityValue = Optional[Union[str, int]]
