"""One error taxonomy for the executor's recovery decisions (the port's
copy of the JAX package's ``robustness/errors.py``).

* **oom**: the card could not allocate.  A retry of the same chunk
  usually fails again, but a smaller chunk fits: the executor halves the
  chunk instead of retrying.  ``torch.OutOfMemoryError`` (its message
  says "CUDA out of memory"), a kernel wrapper's launch failure with
  ``cudaError 2`` (``cudaErrorMemoryAllocation``) and the injected ``oom``
  fault all land here.
* **transient**: worth retrying in place: I/O errors (``OSError``),
  lane hangs broken by the watchdog (``TimeoutError``), and an OOM the
  caller cannot split.
* **permanent**: malformed input and logic errors (``ValueError``), and
  every *sticky* CUDA error: an illegal address, a launch failure or an
  assert leaves the CUDA context unusable, so every later call on it
  fails too and a retry would only hide the fault.  ``STICKY_CUDA_ERRORS``
  lists them, by code (the kernel wrappers' ``cudaError N``) and by the
  runtime's message (PyTorch's ``CUDA error: ...``).
"""

from __future__ import annotations

import re

import torch

# substrings of RuntimeError messages that mark a device allocation failure:
# PyTorch's "CUDA out of memory", the runtime's string for cudaError 2, and
# the JAX package's RESOURCE_EXHAUSTED kept for its message shape
_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory")
CUDA_ERROR_MEMORY_ALLOCATION = 2

# CUDA errors after which the context is unusable: every later call fails,
# so they are never retried and never split (cudaError_t codes and the
# runtime's cudaGetErrorString text)
STICKY_CUDA_ERRORS = {
    214: "uncorrectable ECC error encountered",
    700: "an illegal memory access was encountered",
    702: "the launch timed out and was terminated",
    709: "context is destroyed",
    710: "device-side assert triggered",
    714: "hardware stack error",
    715: "an illegal instruction was encountered",
    716: "misaligned address",
    717: "operation not supported on global/shared address space",
    718: "invalid program counter",
    719: "unspecified launch failure",
    999: "unknown error",
}

# RuntimeError messages that mark transient runtime trouble worth a retry
_TRANSIENT_MARKERS = (
    "DEADLINE_EXCEEDED",
    "UNAVAILABLE",
    "ABORTED",
    "CANCELLED",
    "INTERNAL: Failed to",
)

_CUDA_CODE = re.compile(r"cudaError (\d+)")


class InjectedFault(Exception):
    """Mixin marking an exception as injected by a FaultPlan; concrete
    faults subclass (kind, real type)."""


class LaneHangError(TimeoutError):
    """A lane section stalled past the watchdog timeout (or an injected
    ``hang`` ran out its bound).  Transient: the work itself is intact,
    so the enclosing retry re-runs it."""


def cuda_error_code(exc: BaseException) -> int | None:
    """The ``cudaError N`` a kernel wrapper put in its message, or None."""
    m = _CUDA_CODE.search(str(exc))
    return int(m.group(1)) if m else None


def is_sticky(exc: BaseException) -> bool:
    """A CUDA error that leaves the context unusable."""
    if not isinstance(exc, RuntimeError):
        return False
    if cuda_error_code(exc) in STICKY_CUDA_ERRORS:
        return True
    text = str(exc)
    return "CUDA error" in text and any(
        s in text for s in STICKY_CUDA_ERRORS.values())


def is_oom(exc: BaseException) -> bool:
    """Device allocation failure: the degradation (chunk-split) class."""
    if isinstance(exc, torch.OutOfMemoryError):
        return True
    if not isinstance(exc, RuntimeError) or is_sticky(exc):
        return False
    return (cuda_error_code(exc) == CUDA_ERROR_MEMORY_ALLOCATION
            or any(m in str(exc) for m in _OOM_MARKERS))


def is_transient(exc: BaseException) -> bool:
    """Worth retrying in place.  OOM is transient too: when the caller
    cannot split (a one-cluster chunk, ``--no-degrade``) a retry after a
    backoff is the only recovery left in place."""
    if isinstance(exc, (OSError, TimeoutError)):
        return True
    if is_sticky(exc):
        return False
    if is_oom(exc):
        return True
    return isinstance(exc, RuntimeError) and any(
        m in str(exc) for m in _TRANSIENT_MARKERS
    )


def classify(exc: BaseException) -> str:
    """``"oom"`` | ``"transient"`` | ``"permanent"``; OOM is transient too,
    but callers that can split check it first."""
    if is_oom(exc):
        return "oom"
    if is_transient(exc):
        return "transient"
    return "permanent"
