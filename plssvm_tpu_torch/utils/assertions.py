"""Debug assertions, toggleable independently of Python's -O flag.

Equivalent of the reference's ``PLSSVM_ASSERT`` (include/plssvm/detail/
assert.hpp — fmt-formatted assertions with source location, switchable
independently of NDEBUG, CMakeLists.txt:469-472).  Enabled by default;
disable with ``PLSSVM_TPU_DISABLE_ASSERTS=1`` for production serving.
"""

from __future__ import annotations

import inspect
import os

_ENABLED = not os.environ.get("PLSSVM_TPU_DISABLE_ASSERTS")


class AssertionFailedError(AssertionError):
    """Raised by plssvm_assert with the call-site location in the message."""


def plssvm_assert(condition: bool, message: str, *args, **kwargs) -> None:
    """Assert a host-side condition with a formatted message + source location.

    reference: detail/assert.hpp (PLSSVM_ASSERT macro).
    """
    if not _ENABLED or condition:
        return
    frame = inspect.stack()[1]
    text = message.format(*args, **kwargs) if (args or kwargs) else message
    raise AssertionFailedError(
        f"Assertion failed at {frame.filename}:{frame.lineno} "
        f"in {frame.function}: {text}"
    )


def asserts_enabled() -> bool:
    return _ENABLED

