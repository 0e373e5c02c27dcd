"""qoc_tpu - GRAPE quantum optimal control on JAX/XLA.

Built from scratch on JAX/XLA with the capabilities of SchusterLab/qoc
(reference at /root/reference): Schrödinger and Lindblad GRAPE with an
extensible cost stack, Adam/L-BFGS-B/SGD optimizers, H5 checkpointing, and
multi-device ensemble sharding.

Public API mirrors the reference's four entry points
(/root/reference/qoc/__init__.py:5-16).
"""

from qoc_tpu.core import (
    evolve_lindblad_discrete,
    evolve_schroedinger_discrete,
    grape_lindblad_discrete,
    grape_schroedinger_discrete,
    grape_unitary,
)
from qoc_tpu.models import (ConstantLindblad, EnsembleLinearHamiltonian,
                            LinearHamiltonian)
from qoc_tpu.parallel import (
    grape_lindblad_ensemble,
    grape_lindblad_multistart,
    grape_schroedinger_ensemble,
    grape_schroedinger_multistart,
)

__version__ = "0.1.0"

__all__ = [
    "evolve_lindblad_discrete",
    "grape_lindblad_discrete",
    "evolve_schroedinger_discrete",
    "grape_schroedinger_discrete",
    "grape_unitary",
    "grape_lindblad_ensemble",
    "grape_lindblad_multistart",
    "grape_schroedinger_ensemble",
    "grape_schroedinger_multistart",
    "LinearHamiltonian",
    "EnsembleLinearHamiltonian",
    "ConstantLindblad",
]
