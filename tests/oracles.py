"""Float64 numpy/scipy references for the driver-level tests.

Independent of qoc_tpu's propagation code: one ``scipy.linalg.expm`` per
step of the Magnus mesh (written out here), costs in plain numpy, gradients
as central finite differences of the reference.
"""

import math

import numpy as np
import scipy.linalg

import jax
import jax.numpy as jnp

from qoc_tpu.core.common import slap_controls_jax
from qoc_tpu.models import MagnusPolicy

EVOLUTION_TIME = 2.0


def interp(t, xs, ys):
    i = int(np.clip(np.searchsorted(xs, t, side="left"), 1, len(xs) - 1))
    return ys[i - 1] + (ys[i] - ys[i - 1]) / (xs[i] - xs[i - 1]) * (
        t - xs[i - 1])


def comm(a, b):
    return a @ b - b @ a


def magnus(gen, dt, t, policy):
    """Magnus term of ``gen`` over [t, t + dt] (Gauss-Legendre nodes,
    arXiv:1709.06483), written out independently of qoc_tpu.ops.magnus."""
    if policy == MagnusPolicy.M2:
        return dt * gen(t + dt / 2)
    if policy == MagnusPolicy.M4:
        c = math.sqrt(3) / 6
        a1, a2 = gen(t + dt * (0.5 - c)), gen(t + dt * (0.5 + c))
        return dt / 2 * (a1 + a2) + math.sqrt(3) / 12 * dt ** 2 * comm(a2,
                                                                       a1)
    c = math.sqrt(15) / 10
    a1, a2, a3 = (gen(t + dt * (0.5 - c)), gen(t + dt / 2),
                  gen(t + dt * (0.5 + c)))
    b1 = dt * a2
    b2 = math.sqrt(15) / 3 * dt * (a3 - a1)
    b3 = 10 / 3 * dt * (a3 - 2 * a2 + a1)
    b12 = comm(b1, b2)
    return b1 + b3 / 12 + comm(-20 * b1 - b3 + b12,
                                b2 - comm(b1, 2 * b3 + b12) / 60) / 240


def trajectory(gen, n_steps, policy, vec0, evolution_time=EVOLUTION_TIME):
    """Vectors after each step 1..n_steps: vec_k = expm(Omega_k) vec_{k-1}."""
    dt = evolution_time / n_steps
    vecs, vec = [], vec0
    for k in range(n_steps):
        vec = scipy.linalg.expm(magnus(gen, dt, k * dt, policy)) @ vec
        vecs.append(vec)
    return vecs


def controls_at(flat, shape):
    real, imag = np.split(flat, 2)
    return (real + 1j * imag).reshape(shape)


def schroedinger_traj(h_of, flat, shape, n_steps, policy, initial,
                      evolution_time=EVOLUTION_TIME):
    controls = controls_at(flat, shape)
    cet = np.linspace(0, evolution_time, shape[0])
    gen = lambda t: -1j * h_of(interp(t, cet, controls), t)
    psi0 = np.concatenate(list(initial), axis=1)          # (d, K)
    return [p.T[..., None] for p in trajectory(gen, n_steps, policy, psi0,
                                               evolution_time)]


def superop(h, gammas, lops):
    d = h.shape[0]
    eye = np.eye(d)
    s = -1j * (np.kron(h, eye) - np.kron(eye, h.T))
    for g, l_op in zip(gammas, lops):
        p = l_op.conj().T @ l_op
        s = s + g * (np.kron(l_op, l_op.conj()) - 0.5 * np.kron(p, eye)
                     - 0.5 * np.kron(eye, p.T))
    return s


def lindblad_traj(h_of, gammas, lops, flat, shape, n_steps, policy, rho0,
                  evolution_time=EVOLUTION_TIME):
    controls = controls_at(flat, shape)
    cet = np.linspace(0, evolution_time, shape[0])
    d = rho0.shape[-1]
    gen = lambda t: superop(h_of(interp(t, cet, controls), t), gammas,
                             lops)
    vec0 = rho0.reshape(rho0.shape[0], d * d).T           # (d^2, K)
    return [v.T.reshape(rho0.shape)
            for v in trajectory(gen, n_steps, policy, vec0, evolution_time)]


def state_fidelity(targets, states):
    overlap = np.sum(np.conj(targets[:, :, 0]) * states[:, :, 0])
    return abs(overlap) ** 2 / targets.shape[0] ** 2


def density_fidelity(targets, densities):
    traces = np.abs(np.einsum("kji,kjl->kil", targets.conj(),
                              densities).trace(axis1=1, axis2=2))
    return traces.sum() / (targets.shape[0] * targets.shape[-1])


def check_value_and_grad(loss_fn, oracle_fn, shape, rng, tol=1e-9):
    """Value and two directional derivatives of ``loss_fn`` (flat real
    params) against the float64 oracle."""
    flat = 0.3 * rng.normal(size=(int(np.prod(shape)) * 2,))

    def scalar(f):
        return loss_fn(slap_controls_jax(True, f, shape))[0]

    value, grad = jax.value_and_grad(scalar)(jnp.asarray(flat))
    assert abs(float(value) - oracle_fn(flat)) < tol
    eps = 1e-5
    for _ in range(2):
        v = rng.normal(size=flat.shape)
        fd = (oracle_fn(flat + eps * v) - oracle_fn(flat - eps * v)) / (
            2 * eps)
        assert abs(float(np.dot(np.asarray(grad), v)) - fd) < 1e-6 * max(
            1.0, abs(fd))


def random_problem(rng, d, n_c):
    h0 = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    ops = 0.5 * (rng.normal(size=(n_c, d, d))
                 + 1j * rng.normal(size=(n_c, d, d)))
    return (h0 + h0.conj().T) / 2, ops


def linear_h(h0, ops):
    def h_of(c, t):
        drive = np.tensordot(c, ops, axes=(0, 0))
        return h0 + drive + drive.conj().T
    return h_of


def basis_states(d, idx):
    out = np.zeros((len(idx), d, 1), dtype=complex)
    for k, i in enumerate(idx):
        out[k, i] = 1
    return out


def flat_controls(controls):
    """Complex (E, C) controls -> the drivers' flat real layout."""
    controls = np.asarray(controls).ravel()
    return np.concatenate((controls.real, controls.imag))
