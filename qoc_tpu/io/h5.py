"""H5 checkpoint files.

Observer/checkpoint layer extracted from the reference's model classes (the
reference writes H5 from inside ``log_and_save`` on the program-state objects,
/root/reference/qoc/models/schroedingermodels.py:209-344 — SURVEY.md §1 flags
this inversion; here it is a standalone writer the drivers call).

Schema parity: dataset names, shapes, dtypes, and preallocation match the
reference so its plotting / resume tooling works on qoc_tpu files. Every open
is guarded by a ``filelock.FileLock`` on ``save_file_path + ".lock"`` so a
live plotting process can read concurrently; a lock timeout drops the write
with a warning and the optimization continues (reference
schroedingermodels.py:93-95,253-255).

Improvement over the reference: ``save_optimizer_state`` / resume support —
the reference never checkpoints Adam moments (SURVEY.md §5).
"""

import numpy as np

__all__ = ["H5Checkpointer", "h5_modules"]

_LOCK_TIMEOUT_S = 10


def h5_modules():
    """``(h5py, FileLock, Timeout)``, imported on first use.

    Only saving, resuming and plotting touch save files, so ``import
    qoc_tpu`` and a run without ``save_file_path`` need neither package.
    """
    try:
        import h5py
        from filelock import FileLock, Timeout
    except ImportError as exc:
        raise ImportError(
            "save files need h5py and filelock: pip install "
            "'qoc-tpu[io]'") from exc
    return h5py, FileLock, Timeout


class H5Checkpointer:
    """Lock-guarded writer for one optimization/evolution save file.

    Multi-host: writes are owned by process 0 (``config.is_io_process``) —
    every other process's write methods are silent no-ops, so the drivers
    can call them unconditionally from their SPMD loops without N hosts
    racing on one file. Reads (``load_optimizer_state``) work on every
    process; resume therefore requires the save file on a shared
    filesystem.
    """

    def __init__(self, save_file_path):
        h5_modules()
        self.save_file_path = save_file_path
        self.lock_path = save_file_path + ".lock"
        from qoc_tpu.config import is_io_process
        self._writes_enabled = is_io_process()

    def _locked_write(self, fn, mode="a", what="save"):
        if not self._writes_enabled:
            return
        h5py, FileLock, Timeout = h5_modules()
        try:
            with FileLock(self.lock_path, timeout=_LOCK_TIMEOUT_S):
                with h5py.File(self.save_file_path, mode) as save_file:
                    fn(save_file)
        except Timeout:
            print("Timeout while locking {} during {}."
                  "".format(self.lock_path, what))

    # -- GRAPE schema ------------------------------------------------------

    def create_grape_file(self, pstate, save_count):
        """Preallocate the full GRAPE schema at iteration 0.

        Parity: reference schroedingermodels.py:276-307 /
        lindbladmodels.py:269-300. ``pstate`` duck-types: uses
        ``initial_states`` when present else ``initial_densities``.
        """
        is_schroedinger = hasattr(pstate, "initial_states")
        initial = (pstate.initial_states if is_schroedinger
                   else pstate.initial_densities)
        initial = np.asarray(initial)
        # Ensemble drivers stack a member axis onto the evolved states /
        # densities: (n_members, K, d, ...) instead of the reference's
        # (K, d, ...) (qoc_tpu extension; the reference has no ensembles).
        evolved_shape = tuple(getattr(pstate, "evolved_shape", initial.shape))
        ensemble_params = getattr(pstate, "ensemble_params", None)
        evolved_key = "final_states" if is_schroedinger else "final_densities"
        intermediate_key = ("intermediate_states" if is_schroedinger
                            else "intermediate_densities")
        initial_key = "initial_states" if is_schroedinger else "initial_densities"
        save_intermediate = (pstate.save_intermediate_states_
                             if is_schroedinger
                             else pstate.save_intermediate_densities_)
        initial_controls = np.asarray(pstate.initial_controls)

        def fill(f):
            f["complex_controls"] = pstate.complex_controls
            f["control_count"] = pstate.control_count
            f["control_eval_count"] = pstate.control_eval_count
            f["controls"] = np.zeros(
                (save_count, pstate.control_eval_count, pstate.control_count),
                dtype=initial_controls.dtype)
            f["cost_eval_step"] = pstate.cost_eval_step
            f["cost_names"] = np.array(
                [np.bytes_("{}".format(cost)) for cost in pstate.costs])
            f["error"] = np.repeat(np.finfo(np.float64).max, save_count)
            f["evolution_time"] = pstate.evolution_time
            f[evolved_key] = np.zeros((save_count,) + evolved_shape,
                                      dtype=np.complex128)
            f["grads"] = np.zeros(
                (save_count, pstate.control_eval_count, pstate.control_count),
                dtype=initial_controls.dtype)
            if ensemble_params is not None:
                f["hamiltonian_params"] = np.asarray(ensemble_params)
            f["initial_controls"] = initial_controls
            f[initial_key] = initial
            if save_intermediate:
                f[intermediate_key] = np.zeros(
                    (save_count, pstate.system_eval_count) + evolved_shape,
                    dtype=np.complex128)
            f["interpolation_policy"] = "{}".format(pstate.interpolation_policy)
            f["iteration_count"] = pstate.iteration_count
            if is_schroedinger:
                f["magnus_policy"] = "{}".format(pstate.magnus_policy)
            f["max_control_norms"] = np.asarray(pstate.max_control_norms)
            f["method"] = pstate.method
            f["optimizer"] = "{}".format(pstate.optimizer)
            f["program_type"] = pstate.program_type.value
            f["system_eval_count"] = pstate.system_eval_count

        self._locked_write(fill, mode="w", what="initial save")

    def ensure_grape_capacity(self, save_count, iteration_count=None):
        """Grow the preallocated per-save-step datasets to ``save_count``
        rows (no-op when already large enough).

        Used when a run resumes into its own save file with a larger
        ``iteration_count`` than the original call: the schema preallocated
        rows for the original count (create_grape_file), so the extension
        rewrites each row-indexed dataset with the old rows preserved.
        """
        row_keys = ("controls", "error", "grads", "final_states",
                    "final_densities", "intermediate_states",
                    "intermediate_densities")

        def fill(f):
            for key in row_keys:
                if key not in f:
                    continue
                data = np.asarray(f[key])
                if data.shape[0] >= save_count:
                    continue
                grown = np.zeros((save_count,) + data.shape[1:],
                                 dtype=data.dtype)
                if key == "error":
                    grown[:] = np.finfo(np.float64).max
                grown[:data.shape[0]] = data
                del f[key]
                f[key] = grown
            if iteration_count is not None and "iteration_count" in f:
                del f["iteration_count"]
                f["iteration_count"] = iteration_count

        self._locked_write(fill, what="capacity grow")

    def save_grape_iteration(self, save_step, controls, error, final_evolved,
                             grads, evolved_key):
        """Fill one preallocated row (reference schroedingermodels.py:240-251)."""
        def fill(f):
            f["controls"][save_step] = np.asarray(controls)
            f["error"][save_step] = float(error)
            f[evolved_key][save_step] = np.asarray(final_evolved)
            f["grads"][save_step] = np.asarray(grads)

        self._locked_write(fill, what="iteration save")

    def save_intermediate(self, key, index, states):
        """Write intermediate states/densities.

        ``index`` is ``(save_step, system_eval_step)`` for GRAPE files or
        ``system_eval_step`` for evolve files.
        """
        def fill(f):
            f[key][index] = np.asarray(states).astype(np.complex128)

        self._locked_write(fill, what="intermediate save")

    def save_optimizer_state(self, state_dict):
        """Checkpoint optimizer internals (qoc_tpu extension, SURVEY.md §5)."""
        def fill(f):
            grp = f.require_group("optimizer_state")
            for key, value in state_dict.items():
                if key in grp:
                    del grp[key]
                grp[key] = np.asarray(value)

        self._locked_write(fill, what="optimizer-state save")

    def load_optimizer_state(self):
        """Read back a checkpointed optimizer state, or None."""
        h5py, FileLock, Timeout = h5_modules()
        try:
            with FileLock(self.lock_path, timeout=_LOCK_TIMEOUT_S):
                with h5py.File(self.save_file_path, "r") as f:
                    if "optimizer_state" not in f:
                        return None
                    return {key: np.asarray(val)
                            for key, val in f["optimizer_state"].items()}
        except (Timeout, OSError):
            return None

    # -- Evolve schema -----------------------------------------------------

    def create_evolve_file(self, pstate, controls):
        """Parity: reference schroedingermodels.py:66-95 /
        lindbladmodels.py:60-90."""
        is_schroedinger = hasattr(pstate, "initial_states")
        initial = (pstate.initial_states if is_schroedinger
                   else pstate.initial_densities)
        initial = np.asarray(initial)
        intermediate_key = ("intermediate_states" if is_schroedinger
                            else "intermediate_densities")
        initial_key = ("initial_states" if is_schroedinger
                       else "initial_densities")
        save_intermediate = (pstate.save_intermediate_states_
                             if is_schroedinger
                             else pstate.save_intermediate_densities_)

        def fill(f):
            if controls is not None:
                f["controls"] = np.asarray(controls)
            f["cost_eval_step"] = pstate.cost_eval_step
            f["costs"] = np.array(
                [np.bytes_("{}".format(cost)) for cost in pstate.costs])
            f["evolution_time"] = pstate.evolution_time
            f[initial_key] = initial
            f["interpolation_policy"] = "{}".format(pstate.interpolation_policy)
            if save_intermediate:
                f[intermediate_key] = np.zeros(
                    (pstate.system_eval_count,) + initial.shape,
                    dtype=np.complex128)
            if is_schroedinger:
                f["magnus_policy"] = "{}".format(pstate.magnus_policy)
            f["method"] = pstate.method
            f["program_type"] = pstate.program_type.value
            f["system_eval_count"] = pstate.system_eval_count

        self._locked_write(fill, mode="w", what="initial save")
