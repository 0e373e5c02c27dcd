"""Lindblad master-equation evolution and GRAPE.

Rebuild of /root/reference/qoc/core/lindbladdiscrete.py. Two
integration strategies (qoc_tpu extension; the reference has only adaptive
RKDP5):

- ``LindbladMethod.RKDP5`` (default, reference parity): adaptive
  Dormand-Prince restarted at every system_eval interval with accuracy set by
  ``atol`` (reference lindbladdiscrete.py:427-428, tutorial.py:273-279). The
  evolve path runs the ``lax.while_loop`` integrator; the GRAPE path runs the
  bounded-scan integrator so reverse-mode gradients are the exact
  discretize-then-optimize gradients of the adaptive scheme.
- ``LindbladMethod.MAGNUS_EXPM``: vectorize the densities, build the
  (d^2, d^2) Lindblad superoperator at Magnus collocation nodes, and
  propagate with the same scaling-and-squaring expm as the Schrödinger
  path — fixed cost per step, batched over the time mesh.
"""

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from qoc_tpu.config import (MATMUL_PRECISION, as_complex, device_get,
                            np_complex_dtype, real_dtype)
from qoc_tpu.core.common import initialize_controls, slap_controls_jax
from qoc_tpu.core.graperunner import run_grape
from qoc_tpu.core.schroedinger import _check_interpolation, _magnus_fn
from qoc_tpu.io.resume import apply_resume
from qoc_tpu.models import (
    EvolveLindbladDiscreteState,
    EvolveLindbladResult,
    GrapeLindbladDiscreteState,
    GrapeLindbladResult,
    InterpolationPolicy,
    LindbladMethod,
    MagnusPolicy,
)
from qoc_tpu.ops.expm import expm
from qoc_tpu.ops.interpolate import interpolate_linear_set
from qoc_tpu.ops.lindblad import get_lindbladian, lindblad_superoperator
from qoc_tpu.ops.linalg import mul
from qoc_tpu.ops.rkdp5 import integrate_rkdp5, integrate_rkdp5_scan
from qoc_tpu.optim import Adam

__all__ = ["evolve_lindblad_discrete", "grape_lindblad_discrete"]


def _make_rhs(pstate, controls, cet, hamiltonian_override=None):
    """Time-dependent Lindbladian RHS closure (reference
    lindbladdiscrete.py:444-495)."""
    hamiltonian = (hamiltonian_override if hamiltonian_override is not None
                   else pstate.hamiltonian)
    lindblad_data = pstate.lindblad_data

    def rhs(time, densities):
        if controls is not None and cet is not None:
            controls_t = interpolate_linear_set(time, cet, controls)
        else:
            controls_t = None
        if hamiltonian is not None:
            h = as_complex(hamiltonian(controls_t, time))
        else:
            h = None
        if lindblad_data is not None:
            dissipators, operators = lindblad_data(time)
            if operators is not None:
                operators = as_complex(operators)
        else:
            dissipators, operators = None, None
        return get_lindbladian(densities, dissipators, h, operators)

    return rhs


def build_lindblad_loss(pstate, collect_intermediates=False,
                        differentiable=True, remat="auto", log_path=False,
                        hamiltonian_override=None, pvary_axes=None,
                        density_mesh=None, batch_size=1):
    """Build the loss: controls -> (error, final_densities[, intermediates]).

    Mirrors _evaluate_lindblad_discrete (reference lindbladdiscrete.py:
    357-441): per system_eval interval, integrate the master equation with
    the configured method, accumulating step costs at cost-mesh points;
    non-step costs applied to the final densities.

    ``hamiltonian_override`` substitutes the pstate's Hamiltonian callable
    (used by the ensemble path to close each member's parameters in);
    ``pvary_axes`` marks the density carry as varying over the given mesh
    axes when the loss runs inside ``shard_map``; ``density_mesh`` shards
    the independent density-batch axis K over the first axis of the given
    ``jax.sharding.Mesh`` via a sharding constraint (psum-free data
    parallelism — the Lindblad analog of core/schroedinger.py's
    ``state_mesh``, SURVEY.md §2.4 row 1); ``batch_size`` counts the copies
    of this loss vmapped side by side on one device, which the memory plan
    covers (see core/schroedinger.py).
    """
    _check_interpolation(pstate.interpolation_policy)
    rdt = real_dtype()
    initial_densities = np.asarray(pstate.initial_densities).astype(
        np_complex_dtype())
    dt = float(pstate.dt)
    system_eval_count = pstate.system_eval_count
    final_step = pstate.final_system_eval_step
    cet = (np.asarray(pstate.control_eval_times, dtype=rdt)
           if pstate.control_eval_times is not None else None)
    step_costs = pstate.step_costs
    costs = pstate.costs
    cost_eval_step = pstate.cost_eval_step
    method = getattr(pstate, "method_", LindbladMethod.RKDP5)
    atol = getattr(pstate, "atol", 1e-12)
    rtol = getattr(pstate, "rtol", 0.0)
    max_steps = getattr(pstate, "rkdp5_max_steps", 16384)
    hilbert_size = initial_densities.shape[-1]
    density_count = initial_densities.shape[0]
    density_sharding = None
    if density_mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec
        n_density_shards = density_mesh.devices.size
        if density_count % n_density_shards != 0:
            raise ValueError(
                "density count {} must be divisible by the density mesh "
                "size {}".format(density_count, n_density_shards))
        density_sharding = NamedSharding(
            density_mesh, PartitionSpec(density_mesh.axis_names[0]))
    if method == LindbladMethod.MAGNUS_EXPM:
        magnus = _magnus_fn(getattr(pstate, "magnus_policy_",
                                    MagnusPolicy.M2))
        hamiltonian = (hamiltonian_override
                       if hamiltonian_override is not None
                       else pstate.hamiltonian)
        lindblad_data = pstate.lindblad_data

        def make_superop_generator(controls):
            def generator(t):
                if controls is not None and cet is not None:
                    controls_t = interpolate_linear_set(t, cet, controls)
                else:
                    controls_t = None
                h = (as_complex(hamiltonian(controls_t, t))
                     if hamiltonian is not None else None)
                if lindblad_data is not None:
                    dissipators, operators = lindblad_data(t)
                    if operators is not None:
                        operators = as_complex(operators)
                else:
                    dissipators, operators = None, None
                return lindblad_superoperator(dissipators, h, operators,
                                              hilbert_size=hilbert_size)
            return generator

        # Blocked batched propagation (same design as the Schrödinger path,
        # core/schroedinger.py): superoperator expms for a whole time block
        # computed batched, composed with a prefix scan (trajectory needed)
        # or a contiguous pairwise tree reduce (final state only).
        sop_dim = hilbert_size * hilbert_size
        n_steps = system_eval_count - 1
        need_trajectory = bool(step_costs) or collect_intermediates
        block = max(1, min(n_steps, (8 * 1024 * 1024)
                           // (sop_dim * sop_dim * batch_size)))
        if remat == "auto":
            # Store residuals (~10 propagator-sized buffers per step) when
            # they fit in device memory; see core/schroedinger.py.
            residual_bytes = (10 * initial_densities.itemsize
                              * n_steps * sop_dim * sop_dim * batch_size)
            remat = residual_bytes > 4 * 1024 ** 3
        n_blocks = -(-n_steps // block)
        pad = n_blocks * block - n_steps
        if log_path:
            print("qoc_tpu: Lindblad propagation path = blocked batched "
                  "Magnus+expm superoperators (d^2={}, block={}, remat={})."
                  "".format(sop_dim, block, bool(remat)))

        def loss(controls):
            generator = make_superop_generator(controls)

            def block_body(carry, xs):
                vec, error = carry  # (K, d^2)
                ks_block, valid = xs
                times = (ks_block - 1).astype(rdt) * dt
                with jax.named_scope("magnus"):
                    mags = jax.vmap(
                        lambda t: magnus(generator, dt, t))(times)
                sops = expm(mags)
                eye = jnp.eye(sop_dim, dtype=sops.dtype)
                sops = jnp.where(valid[:, None, None], sops, eye)
                if need_trajectory:
                    with jax.named_scope("compose"):
                        prefixes = lax.associative_scan(
                            lambda a, b: mul(b, a), sops)
                        vec_all = jnp.einsum("tij,kj->tki", prefixes, vec,
                                             precision=MATMUL_PRECISION)
                    new_vec = vec_all[-1]
                    densities_all = vec_all.reshape(
                        vec_all.shape[0], density_count, hilbert_size,
                        hilbert_size)
                    if step_costs:
                        def one_step_cost(dens, k):
                            step_error = jnp.asarray(0.0, dtype=rdt)
                            for cost in step_costs:
                                step_error = step_error + cost.cost(
                                    controls, dens, k)
                            is_cost_step = (k % cost_eval_step) == 0
                            return jnp.where(is_cost_step, step_error, 0.0)
                        block_costs = jax.vmap(one_step_cost)(
                            densities_all, ks_block)
                        error = error + jnp.sum(
                            jnp.where(valid, block_costs, 0.0))
                    out = densities_all if collect_intermediates else None
                else:
                    with jax.named_scope("compose"):
                        while sops.shape[0] > 1:
                            n = sops.shape[0]
                            if n % 2:
                                sops = jnp.concatenate(
                                    (sops, jnp.broadcast_to(
                                        eye, (1, sop_dim, sop_dim))), axis=0)
                                n += 1
                            pairs = sops.reshape(n // 2, 2, sop_dim, sop_dim)
                            sops = mul(pairs[:, 1], pairs[:, 0])
                        new_vec = jnp.einsum("ij,kj->ki", sops[0], vec,
                                             precision=MATMUL_PRECISION)
                    out = None
                return (new_vec, error), out

            body_fn = jax.checkpoint(block_body) if remat else block_body
            ks = jnp.arange(1, system_eval_count)
            if pad:
                ks = jnp.concatenate(
                    (ks, jnp.full((pad,), system_eval_count,
                                  dtype=ks.dtype)))
            valid = ks < system_eval_count
            xs = (ks.reshape(n_blocks, block),
                  valid.reshape(n_blocks, block))
            vec0 = jnp.asarray(
                initial_densities.reshape(density_count, sop_dim))
            error0 = jnp.asarray(0.0, dtype=rdt)
            if density_sharding is not None:
                vec0 = jax.lax.with_sharding_constraint(vec0,
                                                        density_sharding)
            if pvary_axes:
                vec0 = lax.pcast(vec0, pvary_axes, to="varying")
                error0 = lax.pcast(error0, pvary_axes, to="varying")
            carry = (vec0, error0)
            (vec, error), intermediates = lax.scan(body_fn, carry, xs)
            densities = vec.reshape(density_count, hilbert_size,
                                    hilbert_size)
            for cost in costs:
                if not cost.requires_step_evaluation:
                    error = error + cost.cost(controls, densities,
                                              final_step)
            if density_sharding is not None:
                # Replicate the H5-bound aux for multi-host pulls (see
                # core/schroedinger.py / parallel/ensemble._replicate_aux).
                from jax.sharding import NamedSharding, PartitionSpec
                densities = jax.lax.with_sharding_constraint(
                    densities, NamedSharding(density_mesh, PartitionSpec()))
            if collect_intermediates:
                intermediates = intermediates.reshape(
                    (n_blocks * block,) + intermediates.shape[2:])[:n_steps]
                intermediates = jnp.concatenate(
                    (jnp.asarray(initial_densities)[None], intermediates),
                    axis=0)
                return error, densities, intermediates
            return error, densities

        return loss
    else:
        if log_path:
            print("qoc_tpu: Lindblad propagation path = adaptive RKDP5 "
                  "integrator (reference-parity; "
                  "method=LindbladMethod.MAGNUS_EXPM is the fixed-cost "
                  "batched path).")
        integrate = (integrate_rkdp5_scan if differentiable
                     else integrate_rkdp5)
        if remat == "auto":
            # Store residuals when they fit in device memory (~60 RHS-sized
            # buffers
            # per adaptive interval across the bounded-scan stages).
            dim = hilbert_size * density_count * 60
            residual_bytes = (10 * initial_densities.itemsize
                              * (system_eval_count - 1) * dim * dim
                              * batch_size)
            remat = residual_bytes > 4 * 1024 ** 3

        def advance(densities, controls, time):
            rhs = _make_rhs(pstate, controls, cet, hamiltonian_override)
            x_eval = jnp.reshape(time + dt, (1,))
            kwargs = {"atol": atol, "rtol": rtol}
            if differentiable:
                kwargs["max_steps"] = max_steps
            if pvary_axes:
                # The adaptive carry's internally-created leaves must match
                # the member-varying density axis under shard_map.
                kwargs["pvary_axes"] = pvary_axes
            return integrate(rhs, x_eval, time, densities, **kwargs)[0]

    def loss(controls):
        def body(carry, k):
            densities, error = carry
            time = (k - 1).astype(rdt) * dt
            densities = advance(densities, controls, time)
            if step_costs:
                step_error = jnp.asarray(0.0, dtype=rdt)
                for cost in step_costs:
                    step_error = step_error + cost.cost(controls, densities,
                                                        k)
                is_cost_step = (k % cost_eval_step) == 0
                error = error + jnp.where(is_cost_step, step_error, 0.0)
            out = densities if collect_intermediates else None
            return (densities, error), out

        body_fn = jax.checkpoint(body) if remat else body
        ks = jnp.arange(1, system_eval_count)
        dens0 = jnp.asarray(initial_densities)
        error0 = jnp.asarray(0.0, dtype=rdt)
        if density_sharding is not None:
            dens0 = jax.lax.with_sharding_constraint(dens0,
                                                     density_sharding)
        if pvary_axes:
            dens0 = lax.pcast(dens0, pvary_axes, to="varying")
            error0 = lax.pcast(error0, pvary_axes, to="varying")
        carry = (dens0, error0)
        (densities, error), intermediates = lax.scan(body_fn, carry, ks)
        for cost in costs:
            if not cost.requires_step_evaluation:
                error = error + cost.cost(controls, densities, final_step)
        if density_sharding is not None:
            # Replicate the H5-bound aux for multi-host pulls (see
            # core/schroedinger.py / parallel/ensemble._replicate_aux).
            from jax.sharding import NamedSharding, PartitionSpec
            densities = jax.lax.with_sharding_constraint(
                densities, NamedSharding(density_mesh, PartitionSpec()))
        if collect_intermediates:
            intermediates = jnp.concatenate(
                (initial_densities[None], intermediates), axis=0)
            return error, densities, intermediates
        return error, densities

    return loss


def evolve_lindblad_discrete(evolution_time, initial_densities,
                             system_eval_count, controls=None,
                             cost_eval_step=1, costs=(), hamiltonian=None,
                             interpolation_policy=InterpolationPolicy.LINEAR,
                             lindblad_data=None, save_file_path=None,
                             save_intermediate_densities=False,
                             method=LindbladMethod.RKDP5, atol=1e-12,
                             rtol=0.0, magnus_policy=MagnusPolicy.M2,
                             mesh=None):
    """Evolve density matrices under the Lindblad equation and compute the
    total cost.

    API parity: reference lindbladdiscrete.py:31-107 (the trailing
    ``method``/``atol``/``rtol``/``magnus_policy``/``mesh`` kwargs are
    qoc_tpu extensions). Accuracy of the default RKDP5 path is governed by
    ``atol``, not ``system_eval_count`` (reference lindbladdiscrete.py:
    52-55). ``mesh`` shards the independent density-batch axis K over the
    given device mesh's first axis (see ``build_lindblad_loss``).
    """
    costs = list(costs)
    control_eval_count = controls.shape[0] if controls is not None else 0
    pstate = EvolveLindbladDiscreteState(
        control_eval_count, cost_eval_step, costs, evolution_time,
        hamiltonian, initial_densities, interpolation_policy, lindblad_data,
        save_file_path, save_intermediate_densities, system_eval_count)
    pstate.method_ = method
    pstate.atol = atol
    pstate.rtol = rtol
    pstate.magnus_policy_ = magnus_policy
    pstate.save_initial(controls)
    result = EvolveLindbladResult()

    collect = save_intermediate_densities
    loss = build_lindblad_loss(pstate, collect_intermediates=collect,
                               differentiable=False, remat=False,
                               density_mesh=mesh)
    loss = jax.jit(loss)
    if controls is not None:
        controls = np.asarray(controls).astype(np_complex_dtype())
    out = loss(controls)
    if collect:
        error, final_densities, intermediates = out
        result.intermediate_densities = device_get(intermediates)
        pstate.save_intermediate_densities(result.intermediate_densities)
    else:
        error, final_densities = out
    result.error = float(error)
    result.final_densities = device_get(final_densities)
    return result


def grape_lindblad_discrete(control_count, control_eval_count, costs,
                            evolution_time, initial_densities,
                            system_eval_count, complex_controls=False,
                            cost_eval_step=1, hamiltonian=None,
                            impose_control_conditions=None,
                            initial_controls=None,
                            interpolation_policy=InterpolationPolicy.LINEAR,
                            iteration_count=1000, lindblad_data=None,
                            log_iteration_step=10, max_control_norms=None,
                            min_error=0, optimizer=None, resume_from=None,
                            save_file_path=None,
                            save_intermediate_densities=False,
                            save_iteration_step=0,
                            method=LindbladMethod.RKDP5, atol=1e-12,
                            rtol=0.0, rkdp5_max_steps=16384,
                            magnus_policy=MagnusPolicy.M2, fused_chunk=None,
                            mesh=None):
    """Optimize time-discrete controls for Lindblad evolution (GRAPE).

    API parity: reference lindbladdiscrete.py:110-256 (trailing kwargs are
    qoc_tpu extensions). The RKDP5 GRAPE path bounds each interval's adaptive
    loop at ``rkdp5_max_steps`` accept/reject attempts (reverse-mode needs a
    static bound); raise it if the integrator reports unconverged intervals.
    ``mesh`` shards the independent density-batch axis K over the given
    device mesh's first axis (see ``build_lindblad_loss``).
    """
    costs = list(costs)
    if optimizer is None:
        optimizer = Adam()
    initial_controls, max_control_norms = initialize_controls(
        complex_controls, control_count, control_eval_count, evolution_time,
        initial_controls, max_control_norms)
    pstate = GrapeLindbladDiscreteState(
        complex_controls, control_count, control_eval_count, cost_eval_step,
        costs, evolution_time, hamiltonian, impose_control_conditions,
        initial_controls, initial_densities, interpolation_policy,
        iteration_count, lindblad_data, log_iteration_step,
        max_control_norms, min_error, optimizer, save_file_path,
        save_intermediate_densities, save_iteration_step, system_eval_count)
    pstate.method_ = method
    pstate.atol = atol
    pstate.rtol = rtol
    pstate.rkdp5_max_steps = rkdp5_max_steps
    pstate.magnus_policy_ = magnus_policy
    if fused_chunk is not None:
        pstate.fused_chunk = fused_chunk
    if resume_from is not None:
        apply_resume(pstate, resume_from)
    loss_controls = build_lindblad_loss(pstate, log_path=pstate.should_log,
                                        density_mesh=mesh)
    pstate.log_and_save_initial()
    result = GrapeLindbladResult()
    cc = complex_controls
    shape = pstate.controls_shape

    def loss_flat(flat_params):
        controls = slap_controls_jax(cc, flat_params, shape)
        return loss_controls(controls)

    collect_fn = intermediate_saver = None
    if pstate.save_intermediate_densities_:
        collect_loss = build_lindblad_loss(
            pstate, collect_intermediates=True, differentiable=False,
            remat=False, density_mesh=mesh)
        collect_fn = jax.jit(
            lambda flat: collect_loss(slap_controls_jax(cc, flat, shape))[2])
        intermediate_saver = pstate.save_intermediate_densities

    run_grape(pstate, result, loss_flat, "final_densities",
              ("best_controls", "best_error", "best_final_densities",
               "best_iteration"),
              collect_fn=collect_fn, intermediate_saver=intermediate_saver)
    return result
