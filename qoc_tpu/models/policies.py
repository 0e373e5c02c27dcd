"""Policy enums.

Parity with /root/reference/qoc/models/{interpolationpolicy,magnuspolicy,
operationpolicy,performancepolicy,programtype}.py. ``OperationPolicy`` and
``PerformancePolicy`` are vestigial in the reference (never branched on,
operationpolicy.py:8-16) and are kept only for API compatibility; device
placement in qoc_tpu is controlled by JAX (jit backend / shardings) instead.
"""

from enum import Enum

__all__ = [
    "InterpolationPolicy",
    "MagnusPolicy",
    "OperationPolicy",
    "PerformancePolicy",
    "ProgramType",
    "LindbladMethod",
    "Dummy",
]


class InterpolationPolicy(Enum):
    """How control values are interpolated between control_eval_times."""
    LINEAR = 1

    def __str__(self):
        return self.name.lower()


class MagnusPolicy(Enum):
    """Order of the Magnus expansion used by the Schrödinger propagator."""
    M2 = 2
    M4 = 4
    M6 = 6

    def __str__(self):
        return self.name.lower()


class OperationPolicy(Enum):
    """Vestigial (reference parity only); use JAX device APIs instead."""
    CPU = 1
    GPU = 2
    CPU_SPARSE = 3
    GPU_SPARSE = 4

    def __str__(self):
        return self.name.lower()


class PerformancePolicy(Enum):
    """Vestigial (reference parity only)."""
    TIME = 1
    MEMORY = 2

    def __str__(self):
        return self.name.lower()


class ProgramType(Enum):
    EVOLVE = "evolve"
    GRAPE = "grape"

    def __str__(self):
        return self.value


class LindbladMethod(Enum):
    """Integration strategy for the Lindblad path (qoc_tpu extension).

    RKDP5: adaptive Dormand-Prince, reference-parity semantics (restarted per
    system_eval interval, accuracy set by atol).
    MAGNUS_EXPM: vectorize the density, build the Lindblad superoperator, and
    propagate with Magnus + expm on the d^2-dimensional space — fixed cost
    per step, batched like the Schrödinger propagation.
    """
    RKDP5 = 1
    MAGNUS_EXPM = 2

    def __str__(self):
        return self.name.lower()


class Dummy:
    """Mutable attribute bag (reference qoc/models/dummy.py)."""
    pass
