"""Ensemble-robust GRAPE: batched Hamiltonian parameters sharded over a
device mesh.

The reference has no ensemble or multi-device capability (SURVEY.md §2.4);
this is the BASELINE.json "ensemble-robust GRAPE" configuration: every
ensemble member (a Hamiltonian parameter row — detuning,
amplitude miscalibration, ...) rolls out the full propagation via ``vmap``
inside its mesh shard, per-shard costs and gradients are reduced with
``psum`` over the ``"ensemble"`` mesh axis, and one optimizer step updates
the replicated controls. XLA lowers the collectives to NCCL between the
GPUs of a host (and across hosts after ``jax.distributed.initialize``).
"""

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax import shard_map
from jax.sharding import PartitionSpec as P

from qoc_tpu.config import np_complex_dtype, np_real_dtype
from qoc_tpu.core.common import initialize_controls, slap_controls_jax
from qoc_tpu.core.graperunner import run_grape
from qoc_tpu.core.schroedinger import build_schroedinger_loss
from qoc_tpu.io.resume import apply_resume
from qoc_tpu.models import (
    GrapeSchroedingerDiscreteState,
    GrapeSchroedingerResult,
    InterpolationPolicy,
    MagnusPolicy,
)
from qoc_tpu.optim import Adam
from qoc_tpu.parallel.sharding import ENSEMBLE_AXIS, make_mesh

__all__ = ["grape_schroedinger_ensemble", "build_ensemble_loss"]

def _replicate_aux(mesh):
    """Constraint replicating the member-sharded final states/densities aux.

    The loss's aux feeds H5 rows and result fields through host pulls; with
    ``out_specs=P(axis)`` the global aux is sharded across processes and a
    multi-host ``device_get`` would touch non-addressable shards. The
    constraint makes XLA all-gather it inside the jit, so
    every process holds a full replica — a no-op cost single-device, and
    small (final states only) elsewhere.
    """
    from jax.sharding import NamedSharding
    sharding = NamedSharding(mesh, P())

    def constrain(aux):
        return jax.lax.with_sharding_constraint(aux, sharding)

    return constrain


def build_ensemble_loss(pstate, hamiltonian, hamiltonian_params, mesh,
                        axis_name=ENSEMBLE_AXIS, check_vma=True,
                        time_block_size=None, log_path=False):
    """Build the psum-reduced ensemble loss.

    ``hamiltonian(params_row, controls_t, time) -> (d, d)`` defines one
    member's Hamiltonian. The loss is ``mean_m error_m`` with the member axis
    sharded over ``mesh``; the returned aux is the per-member final states
    stacked along the (sharded) ensemble axis.

    Each member rolls out the blocked Magnus+expm loss of
    core/schroedinger.py under ``vmap`` inside its shard.
    """
    hamiltonian_params = np.asarray(hamiltonian_params)
    hamiltonian_params = hamiltonian_params.astype(
        np_complex_dtype() if np.iscomplexobj(hamiltonian_params)
        else np_real_dtype())
    n_members = hamiltonian_params.shape[0]
    n_shards = mesh.shape[axis_name]
    if n_members % n_shards != 0:
        raise ValueError(
            "ensemble member count {} must be divisible by the mesh axis "
            "size {}".format(n_members, n_shards))

    if log_path:
        print("qoc_tpu: ensemble propagation path = batched Magnus+expm "
              "under vmap ({} members x {} shards).".format(n_members,
                                                            n_shards))

    def member_loss(controls, params_row):
        override = lambda c, t: hamiltonian(params_row, c, t)
        loss = build_schroedinger_loss(
            pstate, hamiltonian_override=override,
            pvary_axes=(axis_name,) if check_vma else None,
            time_block_size=time_block_size,
            batch_size=n_members // n_shards)
        return loss(controls)

    def shard_fn(controls, params_shard):
        errs, states = jax.vmap(
            lambda row: member_loss(controls, row))(params_shard)
        total = lax.psum(jnp.sum(errs), axis_name)
        return total / n_members, states

    sharded = shard_map(shard_fn, mesh=mesh,
                        in_specs=(P(), P(axis_name)),
                        out_specs=(P(), P(axis_name)), check_vma=check_vma)

    replicate = _replicate_aux(mesh)

    def loss(controls):
        err, states = sharded(controls, hamiltonian_params)
        return err, replicate(states)

    return loss


def grape_schroedinger_ensemble(control_count, control_eval_count, costs,
                                evolution_time, hamiltonian,
                                hamiltonian_params, initial_states,
                                system_eval_count, complex_controls=False,
                                cost_eval_step=1,
                                impose_control_conditions=None,
                                initial_controls=None,
                                interpolation_policy=InterpolationPolicy.LINEAR,
                                iteration_count=1000, log_iteration_step=10,
                                magnus_policy=MagnusPolicy.M2,
                                max_control_norms=None, mesh=None,
                                min_error=0, optimizer=None, resume_from=None,
                                save_file_path=None,
                                save_intermediate_states=False,
                                save_iteration_step=0, time_block_size=None,
                                fused_chunk=None,
                                check_vma=True):
    """Robust GRAPE over an ensemble of Hamiltonians (qoc_tpu extension).

    Same contract as :func:`qoc_tpu.grape_schroedinger_discrete` (including
    ``resume_from``/``save_intermediate_states``/``time_block_size``/
    ``fused_chunk``) except:
    - ``hamiltonian(params_row, controls_t, time) -> (d, d)`` takes a member
      parameter row first,
    - ``hamiltonian_params`` :: array (n_members, ...) — one row per member;
      the optimized error is the ensemble mean,
    - ``mesh`` :: jax.sharding.Mesh with an "ensemble" axis (default: 1-D
      mesh over all local devices). n_members must be divisible by the mesh
      axis size.

    ``result.best_final_states`` has shape (n_members, K, d, 1), and the H5
    schema's ``final_states``/``intermediate_states`` datasets carry the
    same leading member axis (plus a ``hamiltonian_params`` dataset) — the
    one intentional divergence from the reference schema
    (/root/reference/qoc/models/schroedingermodels.py:276-307), which has no
    ensemble concept. ``qoc_tpu.plot`` reads both layouts.
    """
    costs = list(costs)
    if optimizer is None:
        optimizer = Adam()
    if mesh is None:
        mesh = make_mesh()
    initial_controls, max_control_norms = initialize_controls(
        complex_controls, control_count, control_eval_count, evolution_time,
        initial_controls, max_control_norms)
    pstate = GrapeSchroedingerDiscreteState(
        complex_controls, control_count, control_eval_count, cost_eval_step,
        costs, evolution_time, None, impose_control_conditions,
        initial_controls, initial_states, interpolation_policy,
        iteration_count, log_iteration_step, max_control_norms,
        magnus_policy, min_error, optimizer, save_file_path,
        save_intermediate_states, save_iteration_step, system_eval_count)
    hamiltonian_params = np.asarray(hamiltonian_params)
    pstate.evolved_shape = ((hamiltonian_params.shape[0],)
                            + np.asarray(initial_states).shape)
    pstate.ensemble_params = hamiltonian_params
    if fused_chunk is not None:
        pstate.fused_chunk = fused_chunk
    if resume_from is not None:
        apply_resume(pstate, resume_from)
    loss_controls = build_ensemble_loss(pstate, hamiltonian,
                                        hamiltonian_params, mesh,
                                        check_vma=check_vma,
                                        time_block_size=time_block_size,
                                        log_path=pstate.should_log)
    pstate.log_and_save_initial()
    result = GrapeSchroedingerResult()
    cc = complex_controls
    shape = pstate.controls_shape

    def loss_flat(flat_params):
        controls = slap_controls_jax(cc, flat_params, shape)
        return loss_controls(controls)

    collect_fn = intermediate_saver = None
    if pstate.save_intermediate_states_:
        members = hamiltonian_params.astype(
            np_complex_dtype() if np.iscomplexobj(hamiltonian_params)
            else np_real_dtype())

        def collect(flat):
            controls = slap_controls_jax(cc, flat, shape)

            def member_intermediates(row):
                override = lambda c, t: hamiltonian(row, c, t)
                closs = build_schroedinger_loss(
                    pstate, collect_intermediates=True, remat=False,
                    hamiltonian_override=override,
                    time_block_size=time_block_size)
                return closs(controls)[2]            # (S, K, d, 1)

            inters = jax.vmap(member_intermediates)(jnp.asarray(members))
            return jnp.moveaxis(inters, 0, 1)        # (S, M, K, d, 1)

        collect_fn = jax.jit(collect)
        intermediate_saver = pstate.save_intermediate_states

    run_grape(pstate, result, loss_flat, "final_states",
              ("best_controls", "best_error", "best_final_states",
               "best_iteration"),
              collect_fn=collect_fn, intermediate_saver=intermediate_saver)
    return result
