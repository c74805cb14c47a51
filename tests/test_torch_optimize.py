"""The port's optimizers against the JAX package's, on the CPU.

Everything runs in float64 (the JAX package under the harness's x64).
Tolerances:

- ``minimize_lbfgs`` on a strictly convex quadratic, Rosenbrock in 2
  and 10 dimensions, and a weighted multinomial logistic loss of
  ``_fit_mlr``'s form: both packages within 1e-6 of the known optimum
  (the quadratic's solve, Rosenbrock's ones) or of each other's
  optimum, relative to its largest entry (the logistic loss), and the
  port's gradient norm at most ``tol`` where it stopped before
  ``max_iters``; iterates need not match optax's;
- ``stiefel_minimize`` on the Procrustes cost ``-tr(WᵀA)``: the first
  5 iterates to 1e-10 of the JAX package's (the algorithm has no
  line-search branch that rounding could flip), and the converged W
  to 1e-6 of A's polar factor;
- ``minimize_bounded`` on box-constrained quadratics (optimum on the
  boundary, optimum inside) to 1e-6 of the JAX package's result.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brainiak_tpu.ops import optimize as jopt
from brainiak_tpu_torch.ops import optimize as topt

F64 = torch.float64


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def _grad_norm(fun, x):
    grad, _ = torch.func.grad_and_value(fun)(x)
    return float(torch.linalg.vector_norm(grad))


def test_bounded_transforms_invert():
    lo, hi = _t([-2.0, 0.0]), _t([3.0, 1.0])
    x = _t([0.5, 0.25])
    z = topt._to_unbounded(x, lo, hi)
    np.testing.assert_allclose(topt._to_bounded(z, lo, hi).numpy(),
                               x.numpy(), atol=1e-12)
    np.testing.assert_allclose(
        z.numpy(), np.asarray(jopt._to_unbounded(jnp.asarray(x.numpy()),
                                                 jnp.asarray(lo.numpy()),
                                                 jnp.asarray(hi.numpy()))),
        atol=1e-12)


def _quadratic(lib, a, b):
    return lambda x: 0.5 * x @ a @ x - b @ x


def _rosenbrock(lib):
    return lambda x: lib.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                             + (1.0 - x[:-1]) ** 2)


def test_lbfgs_quadratic_reaches_the_solve():
    rng = np.random.RandomState(0)
    m = rng.randn(8, 8)
    a = m @ m.T + np.eye(8)
    b = rng.randn(8)
    want = np.linalg.solve(a, b)
    xt, vt = topt.minimize_lbfgs(_quadratic(torch, _t(a), _t(b)),
                                 torch.zeros(8, dtype=F64))
    xj, _ = jopt.minimize_lbfgs(
        _quadratic(jnp, jnp.asarray(a), jnp.asarray(b)), jnp.zeros(8))
    for x in (xt.numpy(), np.asarray(xj)):
        np.testing.assert_allclose(x, want, atol=1e-6, rtol=0)
    assert _grad_norm(_quadratic(torch, _t(a), _t(b)), xt) <= 1e-6
    assert float(vt) == pytest.approx(-0.5 * b @ want, rel=1e-10)


@pytest.mark.parametrize("n", [2, 10])
def test_lbfgs_rosenbrock_reaches_the_ones(n):
    x0 = np.full(n, -1.2)
    x0[1::2] = 1.0
    xt, vt = topt.minimize_lbfgs(_rosenbrock(torch), _t(x0),
                                 max_iters=200)
    xj, _ = jopt.minimize_lbfgs(_rosenbrock(jnp), jnp.asarray(x0),
                                max_iters=200)
    for x in (xt.numpy(), np.asarray(xj)):
        np.testing.assert_allclose(x, np.ones(n), atol=1e-6, rtol=0)
    assert _grad_norm(_rosenbrock(torch), xt) <= 1e-6
    assert float(vt) <= 1e-12


def _mlr_problem():
    """60 samples, 3 features, 3 classes, the weights of two subjects
    of 20 and 40 samples."""
    rng = np.random.RandomState(3)
    x = rng.randn(60, 3)
    labels = rng.randint(0, 3, 60)
    x[np.arange(60), labels] += 1.5
    weights = np.r_[np.full(20, 20.0), np.full(40, 40.0)]
    return x, labels, weights


def _mlr_loss(lib, x, labels, weights, alpha_gamma=0.5):
    def loss(p):
        theta = p[:9].reshape(3, 3)
        logits = x @ theta + p[9:][None, :]
        if lib is torch:
            logp = torch.log_softmax(logits, dim=1)
            picked = torch.gather(logp, 1, labels[:, None])[:, 0]
        else:
            import jax
            logp = jax.nn.log_softmax(logits, axis=1)
            picked = jnp.take_along_axis(logp, labels[:, None], axis=1)[:, 0]
        return -alpha_gamma * lib.sum(picked / weights) \
            + 0.5 * lib.sum(theta ** 2)
    return loss


def test_lbfgs_logistic_loss_matches_jax():
    x, labels, weights = _mlr_problem()
    tfun = _mlr_loss(torch, _t(x), torch.tensor(labels), _t(weights))
    xt, vt = topt.minimize_lbfgs(tfun, torch.zeros(12, dtype=F64),
                                 max_iters=200)
    xj, vj = jopt.minimize_lbfgs(
        _mlr_loss(jnp, jnp.asarray(x), jnp.asarray(labels),
                  jnp.asarray(weights)), jnp.zeros(12), max_iters=200)
    xj = np.asarray(xj)
    assert np.abs(xt.numpy() - xj).max() <= 1e-6 * np.abs(xj).max()
    assert float(vt) == pytest.approx(float(vj), rel=1e-10)
    assert _grad_norm(tfun, xt) <= 1e-6
    # the biases' sum stays at zero from a zero start
    assert abs(float(xt[9:].sum())) <= 1e-8


def _procrustes_cost(lib, a):
    return lambda w: -lib.sum(w * a)


def _stiefel_problem():
    rng = np.random.RandomState(5)
    a = rng.randn(20, 4)
    w0, _ = np.linalg.qr(rng.randn(20, 4))
    return a, w0


def test_stiefel_iterates_match_jax():
    a, w0 = _stiefel_problem()
    for n in range(1, 6):
        wt, vt = topt.stiefel_minimize(_procrustes_cost(torch, _t(a)),
                                       _t(w0), max_iters=n)
        wj, vj = jopt.stiefel_minimize(
            _procrustes_cost(jnp, jnp.asarray(a)), jnp.asarray(w0),
            max_iters=n)
        np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-10,
                                   rtol=0, err_msg=f"iterate {n}")
        assert abs(float(vt) - float(vj)) <= 1e-10


def test_stiefel_converges_to_the_polar_factor():
    a, w0 = _stiefel_problem()
    wt, _ = topt.stiefel_minimize(_procrustes_cost(torch, _t(a)), _t(w0),
                                  max_iters=200, tol=1e-10)
    u, _, vt = np.linalg.svd(a, full_matrices=False)
    np.testing.assert_allclose(wt.numpy(), u @ vt, atol=1e-6, rtol=0)
    np.testing.assert_allclose(wt.numpy().T @ wt.numpy(), np.eye(4),
                               atol=1e-12)


def test_stiefel_skips_a_nan_candidate():
    """The full step's candidate is NaN: the ladder takes the next
    one, as the JAX package's does."""
    a, w0 = _stiefel_problem()

    def cost(lib, a_, w0_):
        def fun(w):
            bad = lib.sum(lib.abs(w - w0_)) > 0.5
            return lib.where(bad, math.nan, -lib.sum(w * a_))
        return fun

    wt, vt = topt.stiefel_minimize(cost(torch, _t(a), _t(w0)), _t(w0),
                                   max_iters=3)
    wj, vj = jopt.stiefel_minimize(cost(jnp, jnp.asarray(a),
                                        jnp.asarray(w0)),
                                   jnp.asarray(w0), max_iters=3)
    assert np.isfinite(float(vt)) and float(vt) < -np.sum(w0 * a)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-10,
                               rtol=0)
    assert np.abs(wt.numpy() - w0).sum() <= 0.5


@pytest.mark.parametrize("where", ["boundary", "inside"])
def test_minimize_bounded_matches_jax(where):
    target = np.array([2.0, -0.5, 0.3]) if where == "boundary" else \
        np.array([0.2, -0.4, 0.6])
    lo, hi = np.full(3, -1.0), np.full(3, 1.0)
    x0 = np.zeros(3)

    def fun(lib, t):
        return lambda x: lib.sum((x - t) ** 2)

    xt, vt = topt.minimize_bounded(fun(torch, _t(target)), _t(x0), _t(lo),
                                   _t(hi))
    xj, vj = jopt.minimize_bounded(fun(jnp, jnp.asarray(target)),
                                   jnp.asarray(x0), jnp.asarray(lo),
                                   jnp.asarray(hi))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-6,
                               rtol=0)
    assert abs(float(vt) - float(vj)) <= 1e-6
    assert np.all(xt.numpy() >= lo) and np.all(xt.numpy() <= hi)
    if where == "inside":
        np.testing.assert_allclose(xt.numpy(), target, atol=1e-6)
    else:
        np.testing.assert_allclose(xt.numpy()[1:], target[1:], atol=1e-6)
        assert xt.numpy()[0] > 0.99
