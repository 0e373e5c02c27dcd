"""Multi-start GRAPE: many pulse candidates optimized in parallel.

The BASELINE.json north star calls for "thousands of pulse candidates ...
rolled out in parallel". GRAPE landscapes are non-convex and the reference's
answer is rerunning with different ``initial_controls`` by hand; here the
candidate axis is a batch dimension: every candidate carries its own
controls and Adam state, the whole (loss + grad + update) iteration runs
device-resident — candidates sharded over a ``"candidate"`` mesh axis,
optionally crossed with an ``"ensemble"`` axis for robust-GRAPE multistart
(each candidate's error is the psum-reduced ensemble mean) — and the best
candidate wins. Per-iteration communication is zero for plain multistart
(candidates are independent); ensemble multistart psums member partials.
The chunked execution loop, checkpoint/resume, and H5 winner-row machinery
live in parallel/_msrunner.py (shared with the Lindblad multistart).

Each candidate's loss is the blocked Magnus+expm loss of
core/schroedinger.py, vmapped over the shard's candidates (and members).
The per-candidate gradient falls out of one value_and_grad of the shard SUM
(candidates are independent, so d(Σ_c err_c)/d(params_c') =
d err_c'/d params_c').
"""

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from qoc_tpu.config import device_get, np_real_dtype
from qoc_tpu.core.common import initialize_controls, slap_controls_jax
from qoc_tpu.core.schroedinger import build_schroedinger_loss
from qoc_tpu.io.resume import apply_resume
from qoc_tpu.models import (
    GrapeSchroedingerDiscreteState,
    GrapeSchroedingerResult,
    InterpolationPolicy,
    MagnusPolicy,
)
from qoc_tpu.optim import Adam
from qoc_tpu.parallel._msrunner import (
    CANDIDATE_AXIS,
    final_evolved_fn,
    run_multistart,
    validate_multistart_entry,
)
from qoc_tpu.parallel.sharding import ENSEMBLE_AXIS, make_mesh

__all__ = ["grape_schroedinger_multistart"]


def grape_schroedinger_multistart(control_count, control_eval_count, costs,
                                  evolution_time, hamiltonian,
                                  initial_states, system_eval_count,
                                  n_starts=8, complex_controls=False,
                                  cost_eval_step=1,
                                  hamiltonian_params=None,
                                  initial_controls=None,
                                  interpolation_policy=InterpolationPolicy.LINEAR,
                                  iteration_count=1000,
                                  log_iteration_step=10,
                                  magnus_policy=MagnusPolicy.M2,
                                  max_control_norms=None, mesh=None,
                                  min_error=0, optimizer=None,
                                  resume_from=None, save_file_path=None,
                                  save_iteration_step=0, seed=0,
                                  fused_chunk=None,
                                  check_vma=True):
    """Optimize ``n_starts`` independent pulse candidates in parallel and
    return the best (qoc_tpu extension).

    Candidate 0 uses the reference's flat initial controls (or the supplied
    ``initial_controls``); the rest are white-noise seeds
    (reference common.py:78-108 generator). ``n_starts`` must be divisible
    by the mesh's "candidate" axis size.

    Robust-GRAPE multistart: pass ``hamiltonian_params`` (n_members, P) and
    an ensemble-contract ``hamiltonian(params_row, controls, t)`` (e.g. an
    :class:`EnsembleLinearHamiltonian`); each candidate then optimizes the
    ensemble-mean error. A 2-D mesh with axes ("candidate", "ensemble")
    shards both axes; the default mesh puts all devices on the candidate
    axis with a size-1 ensemble axis.

    ``min_error`` terminates the run when any candidate's evaluation
    reaches it. ``save_file_path``/``save_iteration_step`` write standard
    GRAPE H5 rows for the PER-ITERATION winning candidate (its evaluated
    error/controls/gradients; final states recomputed by one forward
    dispatch per save row) — live-plottable with the usual tooling. With
    ``hamiltonian_params`` the rows use the member-extended schema
    (``final_states :: (save_count, n_members, K, d, 1)`` plus a
    ``hamiltonian_params`` dataset), exactly like
    ``grape_schroedinger_ensemble``.

    With ``save_file_path`` set, the full candidate state (params, Adam
    moments, done flags, bests) is checkpointed at every chunk boundary;
    ``resume_from=`` restores it and continues, reproducing the
    uninterrupted run exactly.

    Returns a ``GrapeSchroedingerResult`` for the winning candidate, with
    ``result.errors`` holding every candidate's best error and
    ``result.iterations_per_s`` the aggregate candidate-iteration rate.
    """
    costs = list(costs)
    if optimizer is None:
        optimizer = Adam()
    validate_multistart_entry(optimizer, "grape_schroedinger_multistart",
                              "grape_schroedinger_discrete",
                              hamiltonian, hamiltonian_params)
    ensemble = hamiltonian_params is not None
    if mesh is None:
        if ensemble:
            devices = np.asarray(jax.devices()).reshape(-1, 1)
            from jax.sharding import Mesh
            mesh = Mesh(devices, (CANDIDATE_AXIS, ENSEMBLE_AXIS))
        else:
            mesh = make_mesh(axis_name=CANDIDATE_AXIS)
    n_cand_shards = mesh.shape.get(CANDIDATE_AXIS, 1)
    n_ens_shards = mesh.shape.get(ENSEMBLE_AXIS, 1)
    if n_starts % n_cand_shards != 0:
        raise ValueError("n_starts {} must be divisible by the candidate "
                         "mesh axis size {}".format(n_starts, n_cand_shards))
    if ensemble:
        hamiltonian_params = np.asarray(hamiltonian_params)
        n_members = hamiltonian_params.shape[0]
        if n_members % n_ens_shards != 0:
            raise ValueError(
                "ensemble member count {} must be divisible by the ensemble "
                "mesh axis size {}".format(n_members, n_ens_shards))
    else:
        n_members = 1

    base_controls, max_control_norms = initialize_controls(
        complex_controls, control_count, control_eval_count, evolution_time,
        initial_controls, max_control_norms)
    pstate = GrapeSchroedingerDiscreteState(
        complex_controls, control_count, control_eval_count, cost_eval_step,
        costs, evolution_time, hamiltonian, None, base_controls,
        initial_states, interpolation_policy, iteration_count,
        log_iteration_step, max_control_norms, magnus_policy, min_error,
        optimizer, save_file_path, False, save_iteration_step,
        system_eval_count)
    if ensemble:
        # Member-extended H5 schema (as in grape_schroedinger_ensemble):
        # winner rows carry (n_members, K, d, 1) final states plus the
        # hamiltonian_params dataset.
        pstate.evolved_shape = ((n_members,)
                                + np.asarray(initial_states).shape)
        pstate.ensemble_params = hamiltonian_params
    if resume_from is not None:
        apply_resume(pstate, resume_from)
    if pstate.should_save:
        if pstate.checkpointer._writes_enabled:
            print("QOC is saving this optimization run to {}."
                  "".format(save_file_path))
        if not getattr(pstate, "resuming_same_file", False):
            pstate.checkpointer.create_grape_file(pstate,
                                                  pstate._save_count())
    result = GrapeSchroedingerResult()

    cc = complex_controls
    shape = pstate.controls_shape
    c_per_shard = n_starts // n_cand_shards
    vary_axes = ((CANDIDATE_AXIS, ENSEMBLE_AXIS) if ensemble
                 else (CANDIDATE_AXIS,))

    # ---- per-shard loss of the candidate-batch SUM --------------------- --
    # shard_loss_sum(clipped_flat (C_s, nflat)) -> (sum_c err_c, errs (C_s,))
    # in the LOCAL-member partial sense; the ensemble psum/mean is applied
    # by the iteration step.
    shard_loss_sum = _make_shard_loss(
        pstate, hamiltonian, hamiltonian_params, ensemble, cc, shape,
        c_per_shard, n_ens_shards, vary_axes, check_vma)
    if pstate.should_log:
        print("qoc_tpu: multistart propagation path = batched Magnus+expm "
              "under vmap ({} candidates{}).".format(
                  n_starts, " x {} members".format(n_members)
                  if ensemble else ""))

    states_fn = final_evolved_fn(build_schroedinger_loss, pstate,
                                 hamiltonian, hamiltonian_params, ensemble,
                                 cc, shape)
    winning_flat = run_multistart(
        pstate, result, mesh, shard_loss_sum, n_starts, ensemble, n_members,
        "final_states", states_fn=states_fn, seed=seed,
        fused_chunk=fused_chunk, check_vma=check_vma)
    # One forward evaluation of the winner reconstructs its final states
    # (per member for robust multistart) — cheaper than carrying state
    # buffers for every candidate through the optimization.
    result.best_final_states = np.asarray(device_get(states_fn(
        jnp.asarray(np.asarray(winning_flat).astype(np_real_dtype())))))
    return result


def _make_shard_loss(pstate, hamiltonian, hamiltonian_params, ensemble, cc,
                     shape, c_per_shard, n_ens_shards, vary_axes, check_vma):
    """Build shard_loss_sum: clipped flat candidate params (C_s, nflat) ->
    (Σ_c local-member error sum, per-candidate local errors (C_s,)), the
    per-candidate loss vmapped over the shard's candidates (and members).
    """
    if ensemble:
        members = np.asarray(hamiltonian_params)
        m_per_shard = members.shape[0] // n_ens_shards

        def member_loss(controls, params_row):
            override = lambda c, t: hamiltonian(params_row, c, t)
            loss = build_schroedinger_loss(
                pstate, hamiltonian_override=override,
                pvary_axes=vary_axes if check_vma else None,
                batch_size=c_per_shard * m_per_shard)
            return loss(controls)[0]

        def shard_loss_sum(clipped_flat):
            def candidate_err(flat):
                controls = slap_controls_jax(cc, flat, shape)
                if ENSEMBLE_AXIS in vary_axes and n_ens_shards > 1:
                    shard_index = lax.axis_index(ENSEMBLE_AXIS)
                    rows = lax.dynamic_slice_in_dim(
                        jnp.asarray(members), shard_index * m_per_shard,
                        m_per_shard, axis=0)
                else:
                    rows = jnp.asarray(members)
                errs = jax.vmap(
                    lambda row: member_loss(controls, row))(rows)
                return jnp.sum(errs)

            errs = jax.vmap(candidate_err)(clipped_flat)
            return jnp.sum(errs), errs

        return shard_loss_sum

    loss = build_schroedinger_loss(
        pstate, pvary_axes=vary_axes if check_vma else None,
        batch_size=c_per_shard)

    def shard_loss_sum(clipped_flat):
        def candidate_err(flat):
            return loss(slap_controls_jax(cc, flat, shape))[0]

        errs = jax.vmap(candidate_err)(clipped_flat)
        return jnp.sum(errs), errs

    return shard_loss_sum
