"""Device mesh helpers.

The reference is single-process/single-thread (SURVEY.md §2.4); qoc_tpu's
distribution model is JAX-native: a 1-D ``Mesh`` over an ``"ensemble"`` axis,
``shard_map`` partitioning of the ensemble/state-batch work, and XLA
collectives (``psum``) reducing per-shard cost and gradient contributions —
lowered to NCCL between the GPUs of a host and across hosts.
"""

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec

__all__ = ["ENSEMBLE_AXIS", "make_mesh", "replicated", "shard_leading_axis"]

ENSEMBLE_AXIS = "ensemble"


def make_mesh(n_devices=None, axis_name=ENSEMBLE_AXIS, devices=None):
    """1-D mesh over ``n_devices`` (default: all local devices)."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def replicated(mesh):
    return NamedSharding(mesh, PartitionSpec())


def shard_leading_axis(mesh, axis_name=ENSEMBLE_AXIS):
    return NamedSharding(mesh, PartitionSpec(axis_name))


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None):
    """Multi-host bring-up: thin wrapper over ``jax.distributed.initialize``.

    Pass all three arguments (the coordinator as ``host:port``): nothing in
    the environment tells JAX of the cluster. After this, ``jax.devices()``
    spans every process's GPUs and ``make_mesh`` builds a global mesh whose
    collectives run over NVLink within a host and the network across
    hosts.
    """
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
