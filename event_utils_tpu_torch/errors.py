"""Structured error taxonomy of the PyTorch port.

The class names and bases are those of ``event_utils_tpu.errors``, so that
parity tests can assert that both packages raise the same types. The port
keeps its own copy: it imports nothing of the JAX package. It adds one
class, ``DeviceUnavailableError``, for entry points that were asked to run
on a card that is not there.

Hierarchy::

    EventUtilsError
    ├── ConfigurationError (ValueError)    bad arguments / options / shapes
    │   ├── SensorLimitError               sensor formulation limits
    │   └── RegistryError (KeyError)       unknown name in a registry
    ├── DataError
    │   ├── DataNotFoundError (FileNotFoundError)
    │   ├── DataFormatError (ValueError)   inconsistent / corrupt data
    │   └── DatasetInitError (RuntimeError) loader postcondition violated
    ├── NativeBuildError (RuntimeError)    native toolchain / library failure
    └── DeviceUnavailableError (RuntimeError) no CUDA card for a card path
"""

from __future__ import annotations


class EventUtilsError(Exception):
    """Base class of every error raised by event_utils_tpu_torch."""


class ConfigurationError(EventUtilsError, ValueError):
    """Invalid arguments, options, or shapes supplied by the caller."""


class SensorLimitError(ConfigurationError):
    """The requested sensor size / bin count exceeds a kernel formulation
    limit."""


class RegistryError(ConfigurationError, KeyError):
    """Unknown name looked up in an object registry (objectives, warps).

    Subclasses ``KeyError`` (registries are mappings) *and*
    ``ConfigurationError`` (the name is caller-supplied configuration).
    ``str()`` is overridden because ``KeyError`` repr-quotes its message.
    """

    def __str__(self):  # KeyError would repr() the message
        return Exception.__str__(self)


class DataError(EventUtilsError):
    """Problems with event data files or their contents."""


class DataNotFoundError(DataError, FileNotFoundError):
    """An expected data file / directory / in-file dataset is missing."""


class DataFormatError(DataError, ValueError):
    """Data exists but is inconsistent or malformed."""


class DatasetInitError(DataError, RuntimeError):
    """A dataset loader completed without establishing its required
    members."""


class NativeBuildError(EventUtilsError, RuntimeError):
    """The CUDA kernels could not be built, loaded or launched."""


class DeviceUnavailableError(EventUtilsError, RuntimeError):
    """An entry point was asked for the card (the default) and there is
    none. Pass ``device="cpu"`` to run the plain versions on the host."""
