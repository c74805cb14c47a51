"""Smooth minimization: L-BFGS, box constraints and the Stiefel manifold.

PyTorch counterpart of ``brainiak_tpu.ops.optimize``.  Gradients come
from ``torch.autograd.grad``; ``fun`` is a function of tensors that
returns a scalar tensor.  The JAX package takes its L-BFGS from optax; the port
writes its own of the same kind (optax 0.2.6's ``lbfgs()``): a memory
of 10 pairs, the two-loop recursion, the same initial scaling, and a
strong-Wolfe zoom line search with optax's constants.  Iterates need
not match optax's; the optimum does.

The loops are plain Python loops over tensor operations on the
device of ``x0`` / ``w0``.  Each stopping test reads one scalar from
the device (one host sync an iteration), and each trial step of the
line search reads its value and slope (one more a trial): the JAX
package runs the same tests on the device inside ``lax.while_loop``.
"""

import math

import numpy as np
import torch

__all__ = ["minimize_bounded", "minimize_lbfgs", "stiefel_minimize"]

#: pairs the L-BFGS memory keeps
LBFGS_MEMORY = 10
#: the zoom line search: its most trial steps, the sufficient-decrease
#: and curvature tolerances, the approximate-decrease tolerance, the
#: growth of the step while the interval is searched, and the interval
#: below which a step of sufficient decrease is taken
LINESEARCH_STEPS = 20
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
INCREASE_FACTOR = 2.0
INTERVAL_THRESHOLD = 1e-5


def _vdot(a, b):
    return torch.sum(a * b)


def _decrease_error(step, value, slope, value0, slope0):
    """Sufficient-decrease error (0 when met; NaN read as +inf)."""
    with np.errstate(all="ignore"):
        err = value - value0 - SLOPE_RTOL * step * slope0
        approx = np.maximum(slope - (2 * SLOPE_RTOL - 1.0) * slope0,
                            value - value0 - APPROX_DEC_RTOL * abs(value0))
        err = np.maximum(np.minimum(approx, err), 0.0)
    return math.inf if np.isnan(err) else float(err)


def _curvature_error(slope, slope0):
    with np.errstate(all="ignore"):
        err = np.maximum(abs(slope) - CURV_RTOL * abs(slope0), 0.0)
    return math.inf if np.isnan(err) else float(err)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc)
    with slope ``fpa`` at ``a`` (NaN when there is none)."""
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    rb, rc = fb - fa - fpa * db, fc - fa - fpa * dc
    big_a = (dc ** 2 * rb - db ** 2 * rc) / denom
    big_b = (-dc ** 3 * rb + db ** 3 * rc) / denom
    return a + (-big_b + np.sqrt(big_b * big_b - 3.0 * big_a * fpa)) \
        / (3.0 * big_a)


def _quadmin(a, fa, fpa, b, fb):
    db = b - a
    return a - fpa / (2.0 * ((fb - fa - fpa * db) / db ** 2))


def _zoom_linesearch(value_and_grad, x, d, value0, slope0, grad0):
    """A step along ``d`` from ``x`` that meets the strong Wolfe
    conditions (Nocedal and Wright, algorithms 3.5 and 3.6, as optax's
    ``zoom_linesearch``): an interval search from a first step of 1,
    doubling, then a zoom by cubic, quadratic or bisection steps; after
    ``LINESEARCH_STEPS`` trials, the best step of sufficient decrease
    seen.  Returns ``(step, value, grad)``."""

    def on_line(step):
        value, grad = value_and_grad(x + float(step) * d)
        v, s = torch.stack([value.detach(),
                            _vdot(grad, d).detach()]).tolist()
        return np.float64(v), np.float64(s), grad

    st = dict(step=0.0, value=value0, grad=grad0, slope=slope0,
              dec=math.inf, low=0.0, v_low=value0, s_low=slope0,
              high=0.0, v_high=value0, s_high=slope0, ref=0.0,
              v_ref=value0, safe=0.0, v_safe=value0, g_safe=grad0)
    found = False
    count = 0
    while True:
        if not found:
            step = 1.0 if count == 0 else INCREASE_FACTOR * st["step"]
            v, s, g = on_line(step)
            dec = _decrease_error(step, v, s, value0, slope0)
            err = max(dec, _curvature_error(s, slope0))
            if dec <= 0.0:
                st.update(safe=step, v_safe=v, g_safe=g)
            set_high = dec > 0.0 or (v >= st["value"] and count > 0)
            set_low = s >= 0.0 and not set_high
            prev = (st["step"], st["value"], st["slope"])
            new = (step, v, s)
            low, high = (new, prev) if set_low else (prev, new)
            st.update(low=low[0], v_low=low[1], s_low=low[2],
                      high=high[0], v_high=high[1], s_high=high[2],
                      ref=low[0], v_ref=low[1])
            found = set_high or set_low or err <= 0.0
            done = err <= 0.0
            failed = count + 1 >= LINESEARCH_STEPS and not done
        else:
            low, high = st["low"], st["high"]
            delta = abs(high - low)
            left, right = min(high, low), max(high, low)
            with np.errstate(all="ignore"):
                cubic = _cubicmin(low, st["v_low"], st["s_low"], high,
                                  st["v_high"], st["ref"], st["v_ref"])
                quad = _quadmin(low, st["v_low"], st["s_low"], high,
                                st["v_high"])
            if left + 0.2 * delta < cubic < right - 0.2 * delta:
                step = float(cubic)
            elif left + 0.1 * delta < quad < right - 0.1 * delta:
                step = float(quad)
            else:
                step = (low + high) / 2.0
            v, s, g = on_line(step)
            dec = _decrease_error(step, v, s, value0, slope0)
            err = max(dec, _curvature_error(s, slope0))
            if dec <= 0.0 and v < st["v_safe"]:
                st.update(safe=step, v_safe=v, g_safe=g)
            done = err <= 0.0
            to_middle = dec > 0.0 or v >= st["v_low"]
            to_low = s * (high - low) >= 0.0 and not to_middle
            old_low = (low, st["v_low"], st["s_low"])
            old_high = (high, st["v_high"], st["s_high"])
            mid = (step, v, s)
            new_high = old_low if to_low else (mid if to_middle
                                               else old_high)
            new_low = old_low if to_middle else mid
            ref = old_high if (to_middle or to_low) else old_low
            st.update(low=new_low[0], v_low=new_low[1], s_low=new_low[2],
                      high=new_high[0], v_high=new_high[1],
                      s_high=new_high[2], ref=ref[0], v_ref=ref[1])
            failed = (count + 1 >= LINESEARCH_STEPS
                      or (delta <= INTERVAL_THRESHOLD
                          and st["safe"] > 0.0)) and not done
        st.update(step=step, value=v, grad=g, slope=s, dec=dec)
        count += 1
        if failed:
            if st["safe"] > 0.0 or math.isinf(st["dec"]):
                st.update(step=st["safe"], value=st["v_safe"],
                          grad=st["g_safe"])
            return st["step"], st["value"], st["grad"]
        if done:
            return st["step"], st["value"], st["grad"]


def _value_and_grad(fun, x):
    """``(fun(x), ∇fun(x))`` by ``torch.autograd.grad`` (a quarter of
    ``torch.func.grad_and_value``'s host time a call)."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        value = fun(xg)
        grad, = torch.autograd.grad(value, xg)
    return value.detach(), grad


def _two_loop(grad, memory, scale):
    """The L-BFGS direction's inverse-Hessian product: ``memory`` holds
    ``(s, y, rho)`` pairs, oldest first."""
    q = grad
    alphas = []
    for s, y, rho in reversed(memory):
        a = rho * _vdot(s, q)
        q = q - a * y
        alphas.append(a)
    q = scale * q
    for (s, y, rho), a in zip(memory, reversed(alphas)):
        q = q + (a - rho * _vdot(y, q)) * s
    return q


def minimize_lbfgs(fun, x0, max_iters=100, tol=1e-8):
    """Minimize ``fun`` from ``x0`` by L-BFGS with a zoom line search.

    The loop stops after ``max_iters`` iterations, or once the 2-norm
    of the gradient at the point a step was taken from is at most
    ``tol`` (the JAX package's rule).  Returns ``(x, fun(x))``.
    """
    def vg(x):
        return _value_and_grad(fun, x)

    x = x0
    value_t, grad = vg(x)
    value = np.float64(value_t.detach().item())
    memory = []
    prev = None
    it = 0
    gnorm = math.inf
    while it < max_iters and gnorm > tol:
        if prev is None:
            scale = torch.clamp(1.0 / torch.linalg.vector_norm(grad),
                                max=1.0)
        else:
            s, y = x - prev[0], grad - prev[1]
            sy = _vdot(s, y)
            rho = torch.where(sy == 0.0, 0.0, 1.0 / sy)
            memory = (memory + [(s, y, rho)])[-LBFGS_MEMORY:]
            yy = _vdot(y, y)
            scale = torch.where(yy > 0.0, sy / yy, 1.0)
        d = -_two_loop(grad, memory, scale)
        slope0, g_norm = torch.stack(
            [_vdot(d, grad), torch.linalg.vector_norm(grad)]).tolist()
        step, value, new_grad = _zoom_linesearch(
            vg, x, d, value, np.float64(slope0), grad)
        prev = (x, grad)
        x = x + float(step) * d
        grad = new_grad
        gnorm = g_norm
        it += 1
    return x, fun(x)


def stiefel_minimize(fun, w0, max_iters=100, tol=1e-6, n_backtrack=10,
                     initial_step=1.0):
    """Minimize ``fun(W)`` over the Stiefel manifold {W : WᵀW = I}.

    Riemannian gradient descent: the Euclidean gradient projected to
    the tangent space (G − W·sym(WᵀG)); ``n_backtrack`` steps
    ``initial_step * 0.5**j`` retracted together by one batched QR with
    its signs fixed, ``fun`` evaluated on all of them by
    ``torch.func.vmap`` (NaN read as +inf), and the best kept if it
    improves on the current value; the loop stops when none does, or
    the projected gradient's norm is at most ``tol``.
    Returns ``(W, value)``.
    """
    batched = torch.func.vmap(fun)
    steps = initial_step * 0.5 ** torch.arange(
        n_backtrack, dtype=w0.dtype, device=w0.device)
    w = w0
    value = fun(w0)
    it = 0
    gnorm = math.inf
    while it < max_iters and gnorm > tol:
        _, g = _value_and_grad(fun, w)
        wtg = w.T @ g
        d = -(g - w @ ((wtg + wtg.T) / 2))
        norm = torch.linalg.vector_norm(d)
        q, r = torch.linalg.qr(w[None] + steps[:, None, None] * d[None])
        sign = torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))
        candidates = q * torch.where(sign == 0, 1.0, sign)[:, None, :]
        values = batched(candidates)
        values = torch.where(torch.isnan(values), math.inf, values)
        best_value, best = torch.min(values, dim=0)
        improved = best_value < value
        w = torch.where(improved,
                        candidates.index_select(0, best.reshape(1))[0], w)
        value = torch.where(improved, best_value, value)
        # if no candidate improves, stop (gnorm -> 0)
        gnorm = torch.where(improved, norm, 0.0).item()
        it += 1
    return w, value


def _to_unbounded(x, lo, hi, eps=1e-6):
    frac = torch.clamp((x - lo) / (hi - lo), eps, 1 - eps)
    return torch.log(frac) - torch.log1p(-frac)


def _to_bounded(z, lo, hi):
    return lo + (hi - lo) * torch.sigmoid(z)


def minimize_bounded(fun, x0, lower, upper, max_iters=100, tol=1e-8):
    """Minimize ``fun`` subject to ``lower <= x <= upper``: the box is
    mapped to R^n by x = lo + (hi-lo)·sigmoid(z) and the unconstrained
    problem solved by :func:`minimize_lbfgs`.  Returns ``(x, value)``.
    """
    z0 = _to_unbounded(x0, lower, upper)
    z, value = minimize_lbfgs(lambda z: fun(_to_bounded(z, lower, upper)),
                              z0, max_iters=max_iters, tol=tol)
    return _to_bounded(z, lower, upper), value
