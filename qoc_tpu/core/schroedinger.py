"""Schrödinger-equation evolution and GRAPE.

Rebuild of /root/reference/qoc/core/schroedingerdiscrete.py. The
reference walks the time mesh in a Python loop (``:393``) calling numpy expm
per step and differentiates by autograd taping. Here the propagation exploits
that step unitaries are state-independent: each TIME BLOCK computes all its
Magnus terms and matrix exponentials batched and composes them in
log depth — an associative prefix scan when the trajectory is needed, a
pairwise tree reduce when only the final state matters — with just the blocks
sequential under ``lax.scan``. Backward memory is governed by an auto-remat
policy: residuals are stored when they fit in device memory (fastest) and
rematerialized per block above that, realizing the report's hand-adjoint
memory lesson (report.tex:123-127) without its 2759 MB autograd tape.
"""

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from qoc_tpu.config import (MATMUL_PRECISION, as_complex, device_get,
                            np_complex_dtype, real_dtype)
from qoc_tpu.core.common import initialize_controls, slap_controls_jax
from qoc_tpu.core.graperunner import run_grape
from qoc_tpu.io.resume import apply_resume
from qoc_tpu.models import (
    EvolveSchroedingerDiscreteState,
    EvolveSchroedingerResult,
    GrapeSchroedingerDiscreteState,
    GrapeSchroedingerResult,
    InterpolationPolicy,
    MagnusPolicy,
)
from qoc_tpu.ops.expm import expm
from qoc_tpu.ops.interpolate import interpolate_linear_set
from qoc_tpu.ops.linalg import mul
from qoc_tpu.ops.magnus import magnus_m2, magnus_m4, magnus_m6
from qoc_tpu.optim import Adam

__all__ = ["evolve_schroedinger_discrete", "grape_schroedinger_discrete"]


def _magnus_fn(magnus_policy):
    if magnus_policy == MagnusPolicy.M2:
        return magnus_m2
    if magnus_policy == MagnusPolicy.M4:
        return magnus_m4
    if magnus_policy == MagnusPolicy.M6:
        return magnus_m6
    raise ValueError("Unrecognized magnus policy {}.".format(magnus_policy))


def _check_interpolation(interpolation_policy):
    if interpolation_policy != InterpolationPolicy.LINEAR:
        raise NotImplementedError(
            "The interpolation policy {} is not yet supported for this "
            "method.".format(interpolation_policy))


def build_schroedinger_loss(pstate, collect_intermediates=False,
                            remat="auto", hamiltonian_override=None,
                            pvary_axes=None, time_block_size=None,
                            state_mesh=None, log_path=False, batch_size=1):
    """Build the jitted-to-be loss: controls (complex (E, C) or None) ->
    (error, final_states[, intermediate_states]).

    Mirrors _evaluate_schroedinger_discrete
    (reference schroedingerdiscrete.py:356-438): steps k = 1..S-1 propagate
    then accumulate step costs at cost-mesh points; non-step costs applied to
    the final states.

    ``hamiltonian_override`` substitutes the pstate's Hamiltonian callable —
    used by the ensemble path to close each member's parameters into the
    shared propagation structure (parallel/ensemble.py).

    ``pvary_axes`` marks the initial state carry as varying over the given
    mesh axes — required when the loss runs inside ``shard_map`` and the
    Hamiltonian varies per shard (the scan carry must enter with the same
    varying-axis type it exits with).

    ``time_block_size`` sets how many time steps are batched per sequential
    block (None = auto-sized to ~64 MB of propagator buffer). Within a block
    all Magnus terms and expms are computed batched and composed by a
    log-depth associative scan; only blocks are sequential.

    ``state_mesh`` shards the (independent) state-batch axis K over the
    first axis of the given ``jax.sharding.Mesh`` via a sharding constraint
    — psum-free data parallelism for large-K gate synthesis (K = d unitary
    columns); XLA keeps the propagators replicated and the ``U @ states``
    contraction local, inserting the final cost reduction itself
    (SURVEY.md §2.4 row 1).

    ``batch_size`` is how many copies of this loss run side by side under
    ``vmap`` on one device (ensemble members, multistart candidates); the
    block size and the remat decision budget memory for all of them.
    """
    _check_interpolation(pstate.interpolation_policy)
    rdt = real_dtype()
    initial_states = np.asarray(pstate.initial_states).astype(
        np_complex_dtype())
    dt = float(pstate.dt)
    system_eval_count = pstate.system_eval_count
    final_step = pstate.final_system_eval_step
    hamiltonian = (hamiltonian_override if hamiltonian_override is not None
                   else pstate.hamiltonian)
    magnus = _magnus_fn(pstate.magnus_policy)
    cet = (np.asarray(pstate.control_eval_times, dtype=rdt)
           if pstate.control_eval_times is not None else None)
    step_costs = pstate.step_costs
    costs = pstate.costs
    cost_eval_step = pstate.cost_eval_step

    n_steps = system_eval_count - 1
    d = initial_states.shape[-2]
    state_sharding = None
    if state_mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec
        n_state_shards = state_mesh.devices.size
        if initial_states.shape[0] % n_state_shards != 0:
            raise ValueError(
                "state count {} must be divisible by the state mesh size {}"
                "".format(initial_states.shape[0], n_state_shards))
        state_sharding = NamedSharding(
            state_mesh, PartitionSpec(state_mesh.axis_names[0]))
    need_trajectory = bool(step_costs) or collect_intermediates
    if remat == "auto":
        # Rematerialize blocks only when storing the backward residuals
        # (~10 propagator-sized buffers per step) would not fit comfortably
        # in device memory; below that, keeping residuals is faster than
        # recomputing them.
        residual_bytes = (10 * initial_states.itemsize * n_steps * d * d
                          * batch_size)
        remat = residual_bytes > 4 * 1024 ** 3
    if time_block_size is None:
        # Auto block size: cap the (B, d, d) propagator buffers near 64 MB of
        # complex64 so large-d problems stay within device memory.
        time_block_size = max(1, min(n_steps, (8 * 1024 * 1024)
                                     // (d * d * batch_size)))
    block = int(time_block_size)
    n_blocks = -(-n_steps // block)
    pad = n_blocks * block - n_steps
    if log_path:
        print("qoc_tpu: propagation path = blocked batched Magnus + expm "
              "({}, d={}, block={}, remat={}{}).".format(
                  pstate.magnus_policy, d, block, bool(remat),
                  ", per-step prefixes" if need_trajectory else ""))

    def magnus_term_at(controls, time):
        """Magnus generator for the step [time, time + dt]
        (reference _evolve_step_schroedinger_discrete, :441-502)."""
        def generator(t):
            if controls is not None and cet is not None:
                controls_t = interpolate_linear_set(t, cet, controls)
            else:
                controls_t = None
            h = hamiltonian(controls_t, t)
            return -1j * as_complex(h)
        return magnus(generator, dt, time)

    def step_cost_values(controls, states, k):
        step_error = jnp.asarray(0.0, dtype=rdt)
        for cost in step_costs:
            step_error = step_error + cost.cost(controls, states, k)
        is_cost_step = (k % cost_eval_step) == 0
        return jnp.where(is_cost_step, step_error, 0.0)

    def loss(controls):
        # The step unitaries depend on controls, not on the evolving states,
        # so each block computes all its Magnus terms and expms BATCHED
        # (vmapped over time), combines them with a log-depth associative
        # prefix scan, and only the block-level composition is sequential.
        # This replaces the reference's strictly sequential per-step Python
        # loop (schroedingerdiscrete.py:393).

        def block_body(carry, xs):
            states, error = carry
            ks_block, valid = xs
            times = (ks_block - 1).astype(rdt) * dt
            with jax.named_scope("magnus"):
                mags = jax.vmap(lambda t: magnus_term_at(controls, t))(times)
            us = expm(mags)
            eye = jnp.eye(d, dtype=us.dtype)
            us = jnp.where(valid[:, None, None], us, eye)
            if need_trajectory:
                with jax.named_scope("compose"):
                    # prefixes[j] = U_j @ ... @ U_0 within the block; every
                    # intermediate state is needed for step costs /
                    # recording.
                    prefixes = lax.associative_scan(lambda a, b: mul(b, a),
                                                    us)
                    # states after each step of the block: (B, K, d, 1).
                    states_all = jnp.einsum("tij,kjl->tkil", prefixes,
                                            states,
                                            precision=MATMUL_PRECISION)
                new_states = states_all[-1]
                if step_costs:
                    with jax.named_scope("step_costs"):
                        block_costs = jax.vmap(
                            lambda s, k: step_cost_values(controls, s, k)
                        )(states_all, ks_block)
                        error = error + jnp.sum(
                            jnp.where(valid, block_costs, 0.0))
                out = states_all if collect_intermediates else None
            else:
                # Only the block product is needed: log-depth pairwise tree
                # reduce (half the matmuls of the prefix scan, and no
                # per-step state materialization). Reshape-based pairing
                # keeps the reductions contiguous (no strided gathers).
                with jax.named_scope("compose"):
                    while us.shape[0] > 1:
                        n = us.shape[0]
                        if n % 2:
                            us = jnp.concatenate(
                                (us, jnp.broadcast_to(eye, (1, d, d))),
                                axis=0)
                            n += 1
                        pairs = us.reshape(n // 2, 2, d, d)
                        us = mul(pairs[:, 1], pairs[:, 0])
                    new_states = mul(us[0], states)
                out = None
            return (new_states, error), out

        body_fn = jax.checkpoint(block_body) if remat else block_body
        ks = jnp.arange(1, system_eval_count)
        if pad:
            ks = jnp.concatenate((ks, jnp.full((pad,), system_eval_count,
                                               dtype=ks.dtype)))
        valid = ks < system_eval_count
        xs = (ks.reshape(n_blocks, block), valid.reshape(n_blocks, block))
        states0 = initial_states
        error0 = jnp.asarray(0.0, dtype=rdt)
        if state_sharding is not None:
            states0 = jax.lax.with_sharding_constraint(
                jnp.asarray(states0), state_sharding)
        if pvary_axes:
            states0 = lax.pcast(jnp.asarray(states0), pvary_axes,
                                to="varying")
            error0 = lax.pcast(error0, pvary_axes, to="varying")
        carry = (jnp.asarray(states0), error0)
        (states, error), intermediates = lax.scan(body_fn, carry, xs)
        with jax.named_scope("costs"):
            for cost in costs:
                if not cost.requires_step_evaluation:
                    error = error + cost.cost(controls, states, final_step)
        if state_sharding is not None:
            # Replicate the H5/result-bound aux: sharded over a multi-host
            # mesh it would have non-addressable shards at device_get
            # (multi-host driver contract; see parallel/ensemble.py
            # _replicate_aux).
            from jax.sharding import NamedSharding, PartitionSpec
            states = jax.lax.with_sharding_constraint(
                states, NamedSharding(state_mesh, PartitionSpec()))
        if collect_intermediates:
            # Flatten blocks, drop padding, prepend the initial states (the
            # reference records states at every system_eval step including
            # step 0, schroedingerdiscrete.py:394-402).
            intermediates = intermediates.reshape(
                (n_blocks * block,) + intermediates.shape[2:])[:n_steps]
            intermediates = jnp.concatenate(
                (jnp.asarray(initial_states)[None], intermediates), axis=0)
            return error, states, intermediates
        return error, states

    return loss


def evolve_schroedinger_discrete(evolution_time, hamiltonian, initial_states,
                                 system_eval_count, controls=None,
                                 cost_eval_step=1, costs=(),
                                 interpolation_policy=InterpolationPolicy.LINEAR,
                                 magnus_policy=MagnusPolicy.M2,
                                 save_file_path=None,
                                 save_intermediate_states=False,
                                 time_block_size=None, mesh=None):
    """Evolve state vectors under the Schrödinger equation and compute the
    total cost.

    API parity: reference schroedingerdiscrete.py:28-103. ``hamiltonian`` must
    be jax-traceable: ``(controls_t, time) -> (d, d)`` built from
    ``jax.numpy`` operations.

    Returns an ``EvolveSchroedingerResult`` with ``error`` and
    ``final_states`` (and ``intermediate_states`` when requested).
    """
    costs = list(costs)
    control_eval_count = controls.shape[0] if controls is not None else 0
    pstate = EvolveSchroedingerDiscreteState(
        control_eval_count, cost_eval_step, costs, evolution_time,
        hamiltonian, initial_states, interpolation_policy, magnus_policy,
        save_file_path, save_intermediate_states, system_eval_count)
    pstate.save_initial(controls)
    result = EvolveSchroedingerResult()

    collect = save_intermediate_states
    loss = build_schroedinger_loss(pstate, collect_intermediates=collect,
                                   remat=False,
                                   time_block_size=time_block_size,
                                   state_mesh=mesh)
    loss = jax.jit(loss)
    if controls is not None:
        controls = np.asarray(controls).astype(np_complex_dtype())
    out = loss(controls)
    if collect:
        error, final_states, intermediates = out
        result.intermediate_states = device_get(intermediates)
        pstate.save_intermediate_states(result.intermediate_states)
    else:
        error, final_states = out
    result.error = float(error)
    result.final_states = device_get(final_states)
    return result


def grape_schroedinger_discrete(control_count, control_eval_count, costs,
                                evolution_time, hamiltonian, initial_states,
                                system_eval_count, complex_controls=False,
                                cost_eval_step=1,
                                impose_control_conditions=None,
                                initial_controls=None,
                                interpolation_policy=InterpolationPolicy.LINEAR,
                                iteration_count=1000, log_iteration_step=10,
                                magnus_policy=MagnusPolicy.M2,
                                max_control_norms=None, min_error=0,
                                optimizer=None, resume_from=None,
                                save_file_path=None,
                                save_intermediate_states=False,
                                save_iteration_step=0,
                                time_block_size=None, fused_chunk=None,
                                mesh=None):
    """Optimize time-discrete controls for Schrödinger evolution (GRAPE).

    API parity: reference schroedingerdiscrete.py:106-252. Differences:
    - ``optimizer=None`` defaults to a fresh ``Adam()`` per call (the
      reference's mutable ``Adam()`` default argument is shared across calls),
    - the Adam/SGD path runs as a fused on-device ``lax.scan`` when
      ``impose_control_conditions`` is None (see core/graperunner.py); results
      and logs are identical to the per-iteration host loop,
    - ``resume_from`` (qoc_tpu extension) names a previous run's save file:
      the checkpointed params + optimizer moments + iteration index are
      restored and the optimization continues where it stopped — exactly
      reproducing the uninterrupted trajectory for Adam/SGD. When
      ``resume_from == save_file_path`` the existing file's remaining rows
      are filled in place. The reference's resume is manual and drops Adam
      moments (schroedingerdiscrete.py:164-168),
    - ``mesh`` (qoc_tpu extension) shards the independent state-batch axis K
      over the given device mesh's first axis (psum-free data parallelism
      for large-K gate synthesis; see ``build_schroedinger_loss``).

    Returns a ``GrapeSchroedingerResult`` with the best-seen controls/error/
    final states/iteration.
    """
    costs = list(costs)
    if optimizer is None:
        optimizer = Adam()
    initial_controls, max_control_norms = initialize_controls(
        complex_controls, control_count, control_eval_count, evolution_time,
        initial_controls, max_control_norms)
    pstate = GrapeSchroedingerDiscreteState(
        complex_controls, control_count, control_eval_count, cost_eval_step,
        costs, evolution_time, hamiltonian, impose_control_conditions,
        initial_controls, initial_states, interpolation_policy,
        iteration_count, log_iteration_step, max_control_norms,
        magnus_policy, min_error, optimizer, save_file_path,
        save_intermediate_states, save_iteration_step, system_eval_count)
    if fused_chunk is not None:
        pstate.fused_chunk = fused_chunk
    if resume_from is not None:
        apply_resume(pstate, resume_from)
    loss_controls = build_schroedinger_loss(pstate,
                                            time_block_size=time_block_size,
                                            state_mesh=mesh,
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
        collect_loss = build_schroedinger_loss(
            pstate, collect_intermediates=True, remat=False,
            time_block_size=time_block_size, state_mesh=mesh)
        collect_fn = jax.jit(
            lambda flat: collect_loss(slap_controls_jax(cc, flat, shape))[2])
        intermediate_saver = pstate.save_intermediate_states

    run_grape(pstate, result, loss_flat, "final_states",
              ("best_controls", "best_error", "best_final_states",
               "best_iteration"),
              collect_fn=collect_fn, intermediate_saver=intermediate_saver)
    return result
