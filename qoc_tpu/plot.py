"""Plotting utilities for qoc_tpu save files.

Counterpart of /root/reference/qoc/standard/plot.py: reads the H5 save file
under the same FileLock (so it can monitor a live optimization from a second
process, reference tutorial.py:240-243), selects the ``argmin(error)``
iteration by default, and renders controls + their FFT and level populations.
Implemented on matplotlib only (the reference also imports qutip/pandas at
module scope; neither is needed for these plots).
"""

import numpy as np

try:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    _HAVE_MPL = True
except ImportError:  # pragma: no cover
    _HAVE_MPL = False

from qoc_tpu.io.h5 import h5_modules

__all__ = ["plot_controls", "plot_state_population",
           "plot_density_population"]

_LOCK_TIMEOUT_S = 10


def _read_locked(file_path, keys):
    h5py, FileLock, Timeout = h5_modules()
    lock_path = file_path + ".lock"
    try:
        with FileLock(lock_path, timeout=_LOCK_TIMEOUT_S):
            with h5py.File(file_path, "r") as f:
                return {key: np.asarray(f[key]) for key in keys if key in f}
    except Timeout:
        raise RuntimeError("Timeout locking {} for reading."
                           "".format(lock_path))


def _best_index(data, save_index):
    if save_index is not None:
        return save_index
    return int(np.argmin(data["error"]))


def plot_controls(file_path, save_index=None, save_file_path=None,
                  title=None, show=False):
    """Plot control amplitudes over time and their FFT.

    By default plots the lowest-error saved iteration (reference
    plot.py:71-72).
    """
    if not _HAVE_MPL:
        raise ImportError("matplotlib is required for plotting.")
    data = _read_locked(file_path, ("controls", "error", "evolution_time",
                                    "control_eval_count"))
    index = _best_index(data, save_index)
    controls = data["controls"][index]
    evolution_time = float(data["evolution_time"])
    control_eval_count = controls.shape[0]
    times = np.linspace(0, evolution_time, control_eval_count)
    freqs = np.fft.fftshift(np.fft.fftfreq(
        control_eval_count, d=evolution_time / (control_eval_count - 1)))

    fig, (ax_t, ax_f) = plt.subplots(2, 1, figsize=(9, 7))
    for i in range(controls.shape[1]):
        ax_t.plot(times, np.real(controls[:, i]),
                  label="control {} re".format(i))
        if np.iscomplexobj(controls):
            ax_t.plot(times, np.imag(controls[:, i]), linestyle="--",
                      label="control {} im".format(i))
        spectrum = np.fft.fftshift(np.fft.fft(controls[:, i]))
        ax_f.plot(freqs, np.abs(spectrum), label="control {}".format(i))
    ax_t.set_xlabel("time")
    ax_t.set_ylabel("control amplitude")
    ax_t.legend(fontsize=7)
    ax_f.set_xlabel("frequency")
    ax_f.set_ylabel("|FFT|")
    fig.suptitle(title or "{} (iteration index {})".format(file_path, index))
    if save_file_path is not None:
        fig.savefig(save_file_path, dpi=120)
    if show:  # pragma: no cover
        plt.show()
    plt.close(fig)
    return fig


def _plot_populations(times, populations, labels, title, save_file_path,
                      show):
    fig, ax = plt.subplots(figsize=(9, 5))
    for pop, label in zip(populations, labels):
        ax.plot(times, pop, label=label)
    ax.set_xlabel("time")
    ax.set_ylabel("population")
    ax.set_ylim(-0.05, 1.05)
    ax.legend(fontsize=7)
    fig.suptitle(title)
    if save_file_path is not None:
        fig.savefig(save_file_path, dpi=120)
    if show:  # pragma: no cover
        plt.show()
    plt.close(fig)
    return fig


def plot_state_population(file_path, state_index=0, save_index=None,
                          save_file_path=None, title=None, show=False,
                          member=0):
    """Plot level populations |<n|psi(t)>|^2 from saved intermediate states
    (reference plot.py:266-351).

    ``member`` selects the ensemble member for files written by
    ``grape_schroedinger_ensemble`` (which carry a leading member axis on
    the intermediate/final state datasets); ignored for plain files.
    """
    if not _HAVE_MPL:
        raise ImportError("matplotlib is required for plotting.")
    data = _read_locked(file_path, ("intermediate_states", "error",
                                    "evolution_time", "system_eval_count"))
    if "intermediate_states" not in data:
        raise ValueError("The save file {} has no intermediate_states; "
                         "rerun with save_intermediate_states=True."
                         "".format(file_path))
    states = data["intermediate_states"]
    if states.ndim >= 5:  # GRAPE file: (save_count, S, [M,] K, d, 1)
        index = _best_index(data, save_index)
        states = states[index]
    if states.ndim == 5:  # ensemble member axis: (S, M, K, d, 1)
        states = states[:, member]
    evolution_time = float(data["evolution_time"])
    system_eval_count = states.shape[0]
    times = np.linspace(0, evolution_time, system_eval_count)
    psi = states[:, state_index, :, 0]  # (S, d)
    populations = np.abs(psi) ** 2
    labels = ["|{}>".format(level) for level in range(psi.shape[1])]
    return _plot_populations(
        times, populations.T, labels,
        title or "state {} populations".format(state_index),
        save_file_path, show)


def plot_density_population(file_path, density_index=0, save_index=None,
                            save_file_path=None, title=None, show=False,
                            member=0):
    """Plot diagonal populations of saved intermediate densities
    (reference plot.py:178-263). ``member`` selects the ensemble member for
    ensemble-driver files (leading member axis); ignored for plain files."""
    if not _HAVE_MPL:
        raise ImportError("matplotlib is required for plotting.")
    data = _read_locked(file_path, ("intermediate_densities", "error",
                                    "evolution_time"))
    if "intermediate_densities" not in data:
        raise ValueError("The save file {} has no intermediate_densities; "
                         "rerun with save_intermediate_densities=True."
                         "".format(file_path))
    densities = data["intermediate_densities"]
    if densities.ndim >= 5:  # GRAPE file: (save_count, S, [M,] K, d, d)
        index = _best_index(data, save_index)
        densities = densities[index]
    if densities.ndim == 5:  # ensemble member axis: (S, M, K, d, d)
        densities = densities[:, member]
    evolution_time = float(data["evolution_time"])
    times = np.linspace(0, evolution_time, densities.shape[0])
    rho = densities[:, density_index]  # (S, d, d)
    populations = np.real(np.einsum("tii->ti", rho))
    labels = ["|{}>".format(level) for level in range(rho.shape[-1])]
    return _plot_populations(
        times, populations.T, labels,
        title or "density {} populations".format(density_index),
        save_file_path, show)
