"""Shared GRAPE optimization engine.

The reference drives optimization through per-iteration host callbacks
(/root/reference/qoc/core/schroedingerdiscrete.py:249-250 ->
_esdj_wrap:293-353): every iteration pays a Python round trip. qoc_tpu keeps
that host loop only where it is forced to (scipy L-BFGS-B line searches, or a
non-traceable ``impose_control_conditions`` hook) and otherwise runs a
**fused on-device loop**: each iteration = clip-project -> value_and_grad of
the jitted propagation loss -> Adam/SGD update, with best-iterate tracking in
a device-resident carry and per-iteration (error, |grads|) rows pulled only
at chunk boundaries for exact reference-format logging. Each chunk is one
``lax.scan`` over its iterations: one dispatch per chunk.

Reference-parity semantics preserved exactly:
- controls are clipped to max_control_norms *outside* the differentiation
  (projection; gradients are taken at the clipped point w.r.t. the clipped
  controls — reference schroedingerdiscrete.py:307-313 clips with numpy
  before the autograd trace),
- the optimizer updates the *unclipped* parameters,
- iteration i logs the error/gradient evaluated at iteration i's parameters
  before the update; termination on ``error <= min_error`` skips the update,
- the returned gradients in cost format equal du/dx + i. du/dy (the
  reference's post-conjugation convention, schroedingerdiscrete.py:320-324),
  which falls out automatically from differentiating w.r.t. the stripped
  real parameters.

Beyond the reference (SURVEY.md §5 mandates):
- GRAPE intermediate-state/density recording: on save iterations a separate
  forward-only collection dispatch recomputes the trajectory at the logged
  (clipped) controls and writes the H5 ``intermediate_*`` row — the main
  loss keeps its fastest (tree-product, final-state-only) form. Parity
  anchor:
  /root/reference/qoc/models/schroedingermodels.py:320-344 written from
  inside the hot loop; here it costs one extra propagation per *save*
  iteration only.
- Checkpoint/resume: optimizer state (params + moments + step count) is
  snapshotted into the save file at chunk boundaries (fused path) / save
  iterations (host path); ``resume_state`` (set by the drivers from a
  ``resume_from=`` save file) restores it and continues the iteration
  numbering, reproducing the uninterrupted run's trajectory exactly for
  on-device optimizers (Adam/SGD). The reference's resume is manual and
  loses Adam moments (schroedingerdiscrete.py:164-168).
- Observability: a ``RateMeter`` tracks iterations/s (reported as
  ``result.iterations_per_s``) and jax profiler trace spans wrap each
  optimization chunk.
"""

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from qoc_tpu.config import device_get, real_dtype
from qoc_tpu.core.common import (
    clip_control_norms,
    clip_control_norms_jax,
    slap_controls,
    slap_controls_jax,
    strip_controls,
    strip_controls_jax,
)
from qoc_tpu.profiler import RateMeter, trace_annotation

__all__ = ["run_grape"]

_DEFAULT_CHUNK = 200

# Keys in the save file's optimizer_state group that are not optimizer
# pytree leaves.
_RESUME_PARAMS = "__params__"
_RESUME_ITERATION = "__iteration__"
_RESUME_KIND = "checkpoint_kind"
_HOST_PREFIX = "host_"
_OPT_PREFIX = "opt"


def run_grape(pstate, result, loss_flat, evolved_key, result_fields,
              collect_fn=None, intermediate_saver=None):
    """Run the optimization described by ``pstate``.

    Arguments:
    pstate - a GrapeState subclass instance.
    result - the result object to fill.
    loss_flat - traced fn: flat real params (already clipped) ->
        (error, final_evolved).
    evolved_key - "final_states" | "final_densities" (H5 dataset name).
    result_fields - (controls_field, error_field, evolved_field, iter_field)
        attribute names on ``result``.
    collect_fn - optional traced fn: flat real clipped params -> the
        (system_eval_count, ...) intermediate state/density stack; dispatched
        only on save iterations.
    intermediate_saver - callable (iteration, stack) writing the stack to the
        save file (pstate.save_intermediate_states / _densities).
    """
    optimizer = pstate.optimizer
    fused_ok = (getattr(optimizer, "supports_fused", False)
                and pstate.impose_control_conditions is None)
    if fused_ok:
        _run_fused(pstate, result, loss_flat, evolved_key, result_fields,
                   collect_fn, intermediate_saver)
    else:
        _run_host(pstate, result, loss_flat, evolved_key, result_fields,
                  collect_fn, intermediate_saver)


def checkpoint_kind(resume_state):
    """Decode the ``checkpoint_kind`` tag ("single:<Optimizer>" /
    "multistart:<Optimizer>") from a loaded optimizer-state dict, or None
    for files that predate the tag."""
    raw = resume_state.get(_RESUME_KIND)
    if raw is None:
        return None
    val = np.asarray(raw).reshape(()).item()
    return val.decode() if isinstance(val, bytes) else str(val)


def _resume_start(pstate):
    """Iteration index to start at (0 for fresh runs). Rejects checkpoints
    of the wrong kind: a multistart checkpoint's params carry an
    (n_starts, ...) candidate axis that would otherwise surface as an
    opaque reshape error deep inside tracing (the reverse-direction twin of
    parallel/_msrunner.py's single-run rejection)."""
    resume_state = getattr(pstate, "resume_state", None)
    if resume_state is None:
        return 0, None
    kind = checkpoint_kind(resume_state)
    if ((kind or "").startswith("multistart")
            or (kind is None and "ms_best_err" in resume_state)):
        raise ValueError(
            "resume_from file holds a multistart checkpoint, not a "
            "single-run one — resume it through the matching "
            "grape_*_multistart driver (same n_starts) or start this run "
            "fresh.")
    ckpt_opt = kind.split(":", 1)[1] if kind and ":" in kind else None
    if (ckpt_opt is not None
            and ckpt_opt != type(pstate.optimizer).__name__
            and pstate.should_log):
        # Not an error — warm-starting a different optimizer from the
        # checkpointed controls is legitimate — but silent moment loss has
        # surprised users (_restore_opt_state falls back to a fresh state
        # when the leaf keys don't match).
        print("qoc_tpu: resume checkpoint was written by {}; this run uses "
              "{} — restoring params only, optimizer state starts fresh."
              "".format(ckpt_opt, type(pstate.optimizer).__name__))
    if _RESUME_ITERATION not in resume_state:
        return 0, resume_state
    return int(np.asarray(resume_state[_RESUME_ITERATION])), resume_state


def _snapshot_optimizer(pstate, snap):
    if pstate.should_save and pstate.checkpointer is not None:
        snap.setdefault(_RESUME_KIND, np.bytes_(
            "single:" + type(pstate.optimizer).__name__))
        pstate.checkpointer.save_optimizer_state(snap)


# ---------------------------------------------------------------------------
# Host-loop path (L-BFGS-B / user projection hooks)
# ---------------------------------------------------------------------------

def _run_host(pstate, result, loss_flat, evolved_key, result_fields,
              collect_fn=None, intermediate_saver=None):
    cc = pstate.complex_controls
    shape = pstate.controls_shape
    mcn = np.asarray(pstate.max_control_norms)
    optimizer = pstate.optimizer
    vg = jax.jit(jax.value_and_grad(loss_flat, has_aux=True))
    controls_field, error_field, evolved_field, iter_field = result_fields
    iteration_start, resume_state = _resume_start(pstate)
    meter = RateMeter().start()

    state = {"iteration": iteration_start, "cache_key": None,
             "cache_val": None}

    def prepare(params):
        controls = slap_controls(cc, np.asarray(params), shape)
        controls = clip_control_norms(controls, mcn)
        if pstate.impose_control_conditions is not None:
            controls = pstate.impose_control_conditions(controls)
        return controls

    def evaluate(params):
        """Cached loss+grad so scipy's paired fun/jac calls cost one
        dispatch."""
        params = np.asarray(params)
        key = params.tobytes()
        if state["cache_key"] == key:
            return state["cache_val"]
        controls = prepare(params)
        clipped_flat = strip_controls(cc, controls)
        (error, final_evolved), grads = vg(jnp.asarray(clipped_flat))
        error = float(error)
        final_evolved = device_get(final_evolved)
        if np.isnan(error):
            print("qoc_tpu: loss evaluated to NaN. If this is a Lindblad "
                  "RKDP5 run, the adaptive integrator likely exceeded "
                  "rkdp5_max_steps — raise it, relax atol, or switch to "
                  "LindbladMethod.MAGNUS_EXPM.")
        val = (controls, error, final_evolved, np.asarray(grads))
        state["cache_key"] = key
        state["cache_val"] = val
        return val

    if getattr(optimizer, "needs_loss", False):
        # Host L-BFGS line searches probe many trial points wanting only
        # the loss — a forward-only dispatch costs ~1/3 of value_and_grad.
        # The vg cache is still consulted first (f0 at the current iterate
        # is free right after the jacobian call).
        loss_only = jax.jit(lambda p: loss_flat(p)[0])

        def function_wrap(params):
            params = np.asarray(params)
            if state["cache_key"] == params.tobytes():
                _, error, _, _ = state["cache_val"]
            else:
                clipped_flat = strip_controls(cc, prepare(params))
                error = float(loss_only(jnp.asarray(clipped_flat)))
            return error, error <= pstate.min_error
    else:
        def function_wrap(params):
            _, error, _, _ = evaluate(params)
            return error, error <= pstate.min_error

    def jacobian_wrap(params):
        controls, error, final_evolved, grads_flat = evaluate(params)
        grads_cost_format = slap_controls(cc, grads_flat, shape)
        iteration = state["iteration"]
        if error < getattr(result, error_field):
            setattr(result, controls_field, controls)
            setattr(result, error_field, error)
            setattr(result, evolved_field, final_evolved)
            setattr(result, iter_field, iteration)
        pstate.log_and_save(controls, error, final_evolved,
                            grads_cost_format, iteration, evolved_key)
        if _is_save_iteration(pstate, iteration):
            if collect_fn is not None and intermediate_saver is not None:
                clipped_flat = strip_controls(cc, controls)
                stack = device_get(collect_fn(jnp.asarray(clipped_flat)))
                intermediate_saver(iteration, np.asarray(stack))
            snap = {_RESUME_PARAMS: np.asarray(params),
                    _RESUME_ITERATION: np.asarray(iteration)}
            if hasattr(optimizer, "state_dict"):
                for key, value in optimizer.state_dict().items():
                    if value is not None:
                        snap[_HOST_PREFIX + key] = np.asarray(value)
            _snapshot_optimizer(pstate, snap)
        state["iteration"] = iteration + 1
        meter.tick()
        return grads_flat, error <= pstate.min_error

    if resume_state is not None and _RESUME_PARAMS in resume_state:
        x0 = np.asarray(resume_state[_RESUME_PARAMS])
        host_state = {key[len(_HOST_PREFIX):]: value
                      for key, value in resume_state.items()
                      if key.startswith(_HOST_PREFIX)}
        if host_state and hasattr(optimizer, "load_state_dict"):
            optimizer.load_state_dict(host_state)
            optimizer._warm_start = True
    else:
        x0 = strip_controls(cc, np.asarray(pstate.initial_controls))
    iterations = max(0, pstate.iteration_count - iteration_start)
    if iterations == 0:
        # Nothing to run (a resume checkpoint already at/past the requested
        # count, or iteration_count == 0 on a fresh call): evaluate the
        # current controls once so the result is filled (no update, no H5
        # rows) — see the fused path's twin.
        if pstate.should_log:
            if resume_state is not None:
                print("qoc_tpu: resume checkpoint is already at iteration "
                      "{} >= iteration_count {}; evaluating the restored "
                      "controls without optimizing.".format(
                          iteration_start, pstate.iteration_count))
            else:
                print("qoc_tpu: iteration_count is 0; evaluating the "
                      "initial controls without optimizing.")
        controls, error, final_evolved, _ = evaluate(x0)
        setattr(result, controls_field, controls)
        setattr(result, error_field, error)
        setattr(result, evolved_field, final_evolved)
        setattr(result, iter_field, max(0, iteration_start - 1))
        result.iteration_count_ran = 0
        result.iterations_per_s = 0.0
        return
    with trace_annotation("qoc_tpu.grape.host_loop"):
        optimizer.run(function_wrap, iterations, x0, jacobian_wrap)
    result.iteration_count_ran = state["iteration"] - iteration_start
    # Steady rate (first-tick interval excluded): the first iteration
    # carries tracing and compilation, which would put mean_rate off by
    # integer factors on short runs.
    result.iterations_per_s = meter.steady_rate
    result.iterations_per_s_mean = meter.mean_rate


# ---------------------------------------------------------------------------
# Fused on-device path (Adam / SGD)
# ---------------------------------------------------------------------------

def _run_fused(pstate, result, loss_flat, evolved_key, result_fields,
               collect_fn=None, intermediate_saver=None):
    cc = pstate.complex_controls
    shape = pstate.controls_shape
    mcn = np.asarray(pstate.max_control_norms)
    optimizer = pstate.optimizer
    min_error = pstate.min_error
    collect_rows = pstate.should_save
    controls_field, error_field, evolved_field, iter_field = result_fields
    rdt = real_dtype()
    iteration_start, resume_state = _resume_start(pstate)
    meter = RateMeter().start()

    vg = jax.value_and_grad(loss_flat, has_aux=True)

    def projected_loss(flat_params):
        """Scalar loss through the same clip projection as the main
        evaluation — the line-search view of the objective for
        ``needs_loss`` optimizers (LBFGS)."""
        controls_ = slap_controls_jax(cc, flat_params, shape)
        clipped_ = clip_control_norms_jax(controls_, mcn)
        return loss_flat(strip_controls_jax(cc, clipped_))[0]

    def iteration_step(carry, _):
        params, opt_state, done, best = carry
        controls = slap_controls_jax(cc, params, shape)
        clipped = clip_control_norms_jax(controls, mcn)
        clipped_flat = strip_controls_jax(cc, clipped)
        (error, final_evolved), grads = vg(clipped_flat)
        grads_norm = jnp.linalg.norm(grads)

        if getattr(optimizer, "needs_loss", False):
            new_opt_state, new_params = optimizer.update_jax(
                opt_state, grads, params, error, projected_loss)
        else:
            new_opt_state, new_params = optimizer.update_jax(opt_state,
                                                             grads, params)
        # Freeze everything once terminated; `valid` marks rows that really
        # ran (the terminating evaluation itself is still valid/logged).
        valid = ~done
        improved = valid & (error < best["error"])
        best = {
            "error": jnp.where(improved, error, best["error"]),
            "controls_flat": jnp.where(improved, clipped_flat,
                                       best["controls_flat"]),
            "final_evolved": jnp.where(improved, final_evolved,
                                       best["final_evolved"]),
            "iteration": jnp.where(improved, best["count"],
                                   best["iteration"]),
            "count": best["count"] + valid.astype(jnp.int32),
        }
        terminate = error <= min_error
        new_done = done | terminate
        # Termination skips the update: the iteration whose evaluation hits
        # min_error leaves params/opt_state at their evaluated values
        # (reference adam.py:104-106 breaks before update()).
        params = jax.tree_util.tree_map(
            lambda new, old: jnp.where(new_done, old, new), new_params,
            params)
        opt_state = jax.tree_util.tree_map(
            lambda new, old: jnp.where(new_done, old, new), new_opt_state,
            opt_state)
        if collect_rows:
            rows = (error, grads_norm, valid, clipped_flat, grads,
                    final_evolved)
        else:
            rows = (error, grads_norm, valid)
        return (params, opt_state, new_done, best), rows

    chunk_cache = {}

    def run_chunk(carry, length):
        if length not in chunk_cache:
            chunk_cache[length] = jax.jit(
                lambda c: lax.scan(iteration_step, c, None, length=length))
        return chunk_cache[length](carry)

    x0 = strip_controls(cc, np.asarray(pstate.initial_controls))
    probe_shape = jax.eval_shape(loss_flat, jnp.zeros(x0.shape, dtype=rdt))[1]
    if resume_state is not None and _RESUME_PARAMS in resume_state:
        x0 = np.asarray(resume_state[_RESUME_PARAMS])
    params = jnp.asarray(x0.astype(np.dtype(rdt).name))
    opt_state = _restore_opt_state(optimizer.init_state(params),
                                   resume_state)
    done = jnp.asarray(False)
    best = {
        "error": jnp.asarray(np.finfo(np.dtype(rdt).name).max, dtype=rdt),
        "controls_flat": jnp.zeros_like(params),
        "final_evolved": jnp.zeros(probe_shape.shape,
                                   dtype=probe_shape.dtype),
        "iteration": jnp.asarray(0, dtype=jnp.int32),
        "count": jnp.asarray(iteration_start, dtype=jnp.int32),
    }

    def opt_snapshot(carry_params, carry_opt_state, next_iteration):
        """Host dict for save_optimizer_state: params + opt-state leaves +
        the next iteration index."""
        snap = {_RESUME_PARAMS: np.asarray(device_get(carry_params)),
                _RESUME_ITERATION: np.asarray(next_iteration)}
        flat, _ = jax.tree_util.tree_flatten_with_path(carry_opt_state)
        for path, leaf in flat:
            key = _OPT_PREFIX + jax.tree_util.keystr(path)
            snap[key] = np.asarray(device_get(leaf))
        return snap

    chunk = int(getattr(pstate, "fused_chunk", 0) or _DEFAULT_CHUNK)
    iterations_left = max(0, pstate.iteration_count - iteration_start)
    global_iter = iteration_start
    all_errors = []
    carry = (params, opt_state, done, best)
    while iterations_left > 0:
        length = min(chunk, iterations_left)
        with trace_annotation("qoc_tpu.grape.chunk"):
            carry, rows = run_chunk(carry, length)
        _, _, done, best = carry
        rows = device_get(rows)
        if collect_rows:
            (errors, gnorms, valids, controls_rows, grads_rows,
             evolved_rows) = rows
        else:
            errors, gnorms, valids = rows
        n_valid = int(np.sum(valids))
        if n_valid:
            meter.tick(n_valid)
        all_errors.append(np.asarray(errors)[:n_valid])
        for j in range(n_valid):
            iteration = global_iter + j
            _log_row(pstate, iteration, float(errors[j]), float(gnorms[j]))
            if collect_rows and _is_save_iteration(pstate, iteration):
                controls_cf = slap_controls(cc, np.asarray(controls_rows[j]),
                                            shape)
                grads_cf = slap_controls(cc, np.asarray(grads_rows[j]), shape)
                save_step = iteration // pstate.save_iteration_step
                pstate.checkpointer.save_grape_iteration(
                    int(save_step), controls_cf, float(errors[j]),
                    evolved_rows[j], grads_cf, evolved_key)
                if collect_fn is not None and intermediate_saver is not None:
                    stack = device_get(
                        collect_fn(jnp.asarray(controls_rows[j])))
                    intermediate_saver(iteration, np.asarray(stack))
        global_iter += n_valid
        iterations_left -= length
        if pstate.should_save:
            _snapshot_optimizer(
                pstate, opt_snapshot(carry[0], carry[1], global_iter))
        if bool(device_get(done)):
            break

    if global_iter == iteration_start:
        # Nothing ran (a resume_from checkpoint already at/past the
        # requested iteration_count, or iteration_count == 0 on a fresh
        # call): fill the result from one evaluation of the current params
        # instead of returning the sentinel carry (best_error = floatmax,
        # zero controls).
        if pstate.should_log:
            if resume_state is not None:
                print("qoc_tpu: resume checkpoint is already at iteration "
                      "{} >= iteration_count {}; evaluating the restored "
                      "controls without optimizing.".format(
                          iteration_start, pstate.iteration_count))
            else:
                print("qoc_tpu: iteration_count is 0; evaluating the "
                      "initial controls without optimizing.")

        @jax.jit
        def eval_once(params_):
            controls_ = slap_controls_jax(cc, params_, shape)
            clipped_ = clip_control_norms_jax(controls_, mcn)
            error_, evolved_ = loss_flat(strip_controls_jax(cc, clipped_))
            return error_, strip_controls_jax(cc, clipped_), evolved_

        error0, clipped_flat0, evolved0 = device_get(eval_once(carry[0]))
        setattr(result, controls_field,
                slap_controls(cc, np.asarray(clipped_flat0), shape))
        setattr(result, error_field, float(error0))
        setattr(result, evolved_field, np.asarray(evolved0))
        setattr(result, iter_field, max(0, iteration_start - 1))
        result.iteration_count_ran = 0
        result.iterations_per_s = 0.0
        result.errors = np.zeros((0,))
        return

    best = device_get(best)
    setattr(result, controls_field,
            slap_controls(cc, np.asarray(best["controls_flat"]), shape))
    setattr(result, error_field, float(best["error"]))
    setattr(result, evolved_field, np.asarray(best["final_evolved"]))
    setattr(result, iter_field, int(best["iteration"]))
    result.iteration_count_ran = global_iter - iteration_start
    # Steady rate (first-chunk interval excluded — it carries trace+compile;
    # the multistart engine reports the same way, _msrunner.py).
    result.iterations_per_s = meter.steady_rate
    result.iterations_per_s_mean = meter.mean_rate
    result.errors = (np.concatenate(all_errors)
                     if all_errors else np.zeros((0,)))


def _restore_opt_state(opt_state, resume_state):
    """Overwrite opt-state leaves from a checkpoint dict, each cast to its
    template's dtype. Missing keys leave the fresh state (controls-only
    resume)."""
    if resume_state is None:
        return opt_state
    flat, treedef = jax.tree_util.tree_flatten_with_path(opt_state)
    if not flat:
        return opt_state
    keys = [_OPT_PREFIX + jax.tree_util.keystr(path) for path, _ in flat]
    if not all(key in resume_state for key in keys):
        return opt_state
    return jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(np.asarray(resume_state[key]).astype(leaf.dtype))
        for key, (_, leaf) in zip(keys, flat)])


def _is_save_iteration(pstate, iteration):
    if not pstate.should_save or iteration > pstate.final_iteration:
        return False
    return (iteration % pstate.save_iteration_step == 0
            or iteration == pstate.final_iteration)


def _log_row(pstate, iteration, error, grads_norm):
    if not pstate.should_log or iteration > pstate.final_iteration:
        return
    if (iteration % pstate.log_iteration_step == 0
            or iteration == pstate.final_iteration):
        print("{:^6d} | {:^1.8e} | {:^1.8e}".format(iteration, error,
                                                    grads_norm))
