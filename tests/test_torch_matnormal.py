"""The port's matrix-normal tier against the JAX package on the CPU.

``brainiak_tpu_torch.matnormal`` and ``utils.kronecker_solvers`` on
``device="cpu"`` against ``brainiak_tpu.matnormal`` in float64 (the
harness turns the JAX package's x64 on), on the same inputs (numpy
from a seed) and the same parameters (the JAX package's
``init_params``, converted by ``convert.matnormal_params_from_jax``).
Tolerances:

- the Kronecker solves, every covariance class's ``logdet`` / ``solve``
  / ``prec`` / ``cov`` / ``logp``, and the likelihoods: 1e-10
  relative (of the largest entry); the likelihoods' gradients: 1e-8;
- ``MatnormalRegression`` and ``MNRSA`` from the same initial
  parameters (both packages draw them from ``np.random.RandomState``):
  ``final_loss_`` within 1e-6 relative, ``beta_`` within 1e-4 of
  max|β|, ``U_`` within 1e-3 of max|U| (never ``X_0_``: it is
  identified only through ``X_0 X_0ᵀ``), the AR(1) and space
  parameters within 1e-4.  The L-BFGS is not optax's, so the fits are
  held at the optimum: MNRSA and the regression (an AR(1) time
  covariance) run 600 iterations in both packages (at the JAX tests'
  300 MNRSA stops short of it, each package elsewhere on a flat
  valley);
- the JAX tests' own recovery bars (``tests/matnormal/*``, at their
  sizes and seeds) on the port's float32 ``fit``.

A masked ``CovKroneckerFactored`` column covariance is where the port
departs from the JAX package on purpose: its density counts only the
columns the mask keeps (``test_masked_density_counts_observed_columns``).
``test_gp_var_priors`` (``reprsimil.brsa``) has no counterpart until
BRSA is ported.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from brainiak_tpu.matnormal import covs as jcovs
from brainiak_tpu.matnormal import matnormal_likelihoods as jlik
from brainiak_tpu.matnormal import utils as jutils
from brainiak_tpu.matnormal.mnrsa import MNRSA as JMNRSA
from brainiak_tpu.matnormal.regression import \
    MatnormalRegression as JRegression
from brainiak_tpu.utils import kronecker_solvers as jks
from brainiak_tpu_torch import convert
from brainiak_tpu_torch.funcalign.srm import NotFittedError
from brainiak_tpu_torch.matnormal import MNRSA, MatnormalRegression
from brainiak_tpu_torch.matnormal import covs as tcovs
from brainiak_tpu_torch.matnormal import matnormal_likelihoods as tlik
from brainiak_tpu_torch.matnormal import utils as tutils
from brainiak_tpu_torch.utils import kronecker_solvers as tks

F64 = torch.float64
RTOL = 1e-10
GRAD_RTOL = 1e-8


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.as_tensor(np.array(a), dtype=F64)


def _close(got, want, rtol=RTOL):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


def _spd(n, rng):
    A = rng.randn(n, n)
    return A @ A.T + n * np.eye(n)


def _lowers(sizes, rng):
    return [np.linalg.cholesky(_spd(n, rng)) for n in sizes]


# -- Kronecker solves --------------------------------------------------------

@pytest.mark.parametrize("two_d", [True, False])
@pytest.mark.parametrize("name", ["solve_lower_triangular_kron",
                                  "solve_upper_triangular_kron",
                                  "kron_mult"])
def test_kron_solvers_match_jax(name, two_d):
    rng = np.random.RandomState(3)
    Ls = _lowers((2, 3, 2), rng)
    y = rng.randn(12, 3) if two_d else rng.randn(12)
    want = jax.jit(getattr(jks, name))([jnp.asarray(L) for L in Ls],
                                       jnp.asarray(y))
    got = getattr(tks, name)([_t(L) for L in Ls], _t(y))
    _close(got, want)
    dense = np.kron(Ls[0], np.kron(Ls[1], Ls[2]))
    oracle = {"solve_lower_triangular_kron": lambda: np.linalg.solve(
                  dense, y),
              "solve_upper_triangular_kron": lambda: np.linalg.solve(
                  dense.T, y),
              "kron_mult": lambda: dense @ y}[name]()
    _close(got, oracle, rtol=1e-8)


@pytest.mark.parametrize("two_d", [True, False])
@pytest.mark.parametrize("upper", [False, True])
def test_masked_kron_solvers_match_jax(upper, two_d):
    rng = np.random.RandomState(7)
    Ls = _lowers((2, 3, 2), rng)
    mask = np.array([1, 0, 1, 1, 1, 0, 1, 1, 0, 1, 1, 1])
    y = rng.randn(12, 2) if two_d else rng.randn(12)
    name = "solve_{}_triangular_masked_kron".format(
        "upper" if upper else "lower")
    want = getattr(jks, name)([jnp.asarray(L) for L in Ls], jnp.asarray(y),
                              np.asarray(mask))
    got = getattr(tks, name)([_t(L) for L in Ls], _t(y), np.asarray(mask))
    _close(got, want)
    assert np.all(got.numpy()[np.asarray(mask) == 0] == 0.0)


@pytest.mark.parametrize("lower,adjoint", [(True, False), (True, True),
                                           (False, False), (False, True)])
def test_masked_triangular_solve_matches_jax(lower, adjoint):
    rng = np.random.RandomState(8)
    L = np.linalg.cholesky(_spd(5, rng))
    L = L if lower else L.T
    y = rng.randn(5, 2)
    mask = np.array([1, 0, 1, 1, 0])
    want = jks.masked_triangular_solve(jnp.asarray(L), jnp.asarray(y), mask,
                                       lower=lower, adjoint=adjoint)
    got = tks.masked_triangular_solve(_t(L), _t(y), mask, lower=lower,
                                      adjoint=adjoint)
    _close(got, want)


def test_masked_solve_gradient_reaches_the_factors():
    """The masked solve writes its rows out of place, so autograd
    reaches the factors and the right-hand side: its gradient against
    central differences (``torch.autograd.gradcheck``, float64)."""
    rng = np.random.RandomState(9)
    mask = np.array([1, 1, 0, 1, 0, 1])
    Ls = [_t(L).requires_grad_(True) for L in _lowers([2, 3], rng)]
    y = _t(rng.randn(6, 2)).requires_grad_(True)

    def fun(L0, L1, y):
        z = tks.solve_lower_triangular_masked_kron([L0, L1], y, mask)
        return tks.solve_upper_triangular_masked_kron([L0, L1], z, mask)

    assert torch.autograd.gradcheck(fun, (*Ls, y))


# -- covariance classes ------------------------------------------------------

def _cov_cases():
    rng = np.random.RandomState(11)
    sig = [_spd(n, rng) for n in (2, 3)]
    return {
        "identity": lambda: jcovs.CovIdentity(6),
        "isotropic_given": lambda: jcovs.CovIsotropic(6, var=2.5),
        "isotropic_random": lambda: jcovs.CovIsotropic(6),
        "diagonal_given": lambda: jcovs.CovDiagonal(
            6, diag_var=rng.rand(6) + 0.5),
        "diagonal_random": lambda: jcovs.CovDiagonal(6),
        "diagonal_gamma": lambda: jcovs.CovDiagonalGammaPrior(
            6, sigma=rng.rand(6) + 0.5),
        "ar1_given": lambda: jcovs.CovAR1(6, rho=0.4, sigma=1.3),
        "ar1_onsets": lambda: jcovs.CovAR1(6, scan_onsets=[0, 4]),
        "cholesky_given": lambda: jcovs.CovUnconstrainedCholesky(
            Sigma=_spd(6, rng)),
        "cholesky_random": lambda: jcovs.CovUnconstrainedCholesky(size=6),
        "wishart": lambda: jcovs.CovUnconstrainedCholeskyWishartReg(6),
        "inv_cholesky_given": lambda: jcovs.CovUnconstrainedInvCholesky(
            invSigma=_spd(6, rng)),
        "inv_cholesky_random": lambda: jcovs.CovUnconstrainedInvCholesky(
            size=6),
        "kronecker_given": lambda: jcovs.CovKroneckerFactored(
            [2, 3], Sigmas=sig),
        "kronecker_random": lambda: jcovs.CovKroneckerFactored([3, 2]),
        "kronecker_masked": lambda: jcovs.CovKroneckerFactored(
            [2, 3], Sigmas=sig, mask=np.array([1, 0, 1, 1, 1, 0])),
    }


COV_CASES = _cov_cases()


@pytest.mark.parametrize("case", sorted(COV_CASES))
def test_cov_init_params_are_the_jax_packages(case):
    """The port's covariance object of the same class and arguments
    draws the JAX package's initial parameters."""
    jcov = COV_CASES[case]()
    tcov = convert.matnormal_cov_from_jax(jcov)
    assert type(tcov).__name__ == type(jcov).__name__
    assert tcov.size == jcov.size
    for seed in (0, 3):
        jp = convert.matnormal_params_from_jax(jcov.init_params(seed),
                                               device="cpu")
        tp = tcov.init_params(seed)
        for a, b in zip(tutils._leaves(tp), tutils._leaves(jp)):
            assert torch.equal(a, b)


VALUE_CASES = sorted(c for c in COV_CASES if not c.endswith(
    ("isotropic_random", "diagonal_random", "cholesky_random")))


@pytest.fixture(scope="module")
def cov_refs():
    """Each value case's JAX covariance, parameters, X [size, 3] and
    (solve, logdet, logp, prec): the unmasked cases from one jitted
    program (one compile, where eager calls compile op by op), the
    masked one eagerly (its solve reads the mask on the host)."""
    covs = {c: COV_CASES[c]() for c in VALUE_CASES}
    params = {c: cov.init_params(seed=3) for c, cov in covs.items()}
    xs = {c: np.random.RandomState(12).randn(cov.size, 3)
          for c, cov in covs.items()}

    def values(c, p, x):
        cov = covs[c]
        return cov.solve(p, x), cov.logdet(p), cov.logp(p), cov.prec(p)

    plain = [c for c in covs if covs[c].__dict__.get("mask") is None]
    out = jax.jit(lambda ps, xx: {c: values(c, ps[c], xx[c])
                                  for c in plain})(
        {c: params[c] for c in plain},
        {c: jnp.asarray(xs[c]) for c in plain})
    for c in set(covs) - set(plain):
        out[c] = values(c, params[c], jnp.asarray(xs[c]))
    return covs, params, xs, out


@pytest.mark.parametrize("case", VALUE_CASES)
def test_cov_matches_jax(case, cov_refs):
    covs, params, xs, out = cov_refs
    jcov = covs[case]
    tcov = convert.matnormal_cov_from_jax(jcov)
    tp = convert.matnormal_params_from_jax(params[case], device="cpu")
    x = _t(xs[case])
    prec = tcov.prec(tp, like=x)
    for got, want in zip((tcov.solve(tp, x), tcov.logdet(tp),
                          tcov.logp(tp), prec), out[case]):
        _close(got, want)
    if case != "kronecker_masked":   # its precision is singular
        _close(tcov.cov(tp, like=x) @ prec, np.eye(jcov.size), 1e-9)


@pytest.mark.parametrize("case", ["ar1_onsets", "inv_cholesky_random",
                                  "kronecker_random", "diagonal_gamma"])
def test_cov_gradients_match_jax(case):
    """The gradient of logdet + logp + a quadratic form of the solve
    with respect to the covariance parameters."""
    jcov = COV_CASES[case]()
    tcov = convert.matnormal_cov_from_jax(jcov)
    jp = jcov.init_params(seed=4)
    X = np.random.RandomState(13).randn(jcov.size, 2)

    def jfun(p):
        return (jcov.logdet(p) + jcov.logp(p)
                + jnp.sum(jnp.asarray(X) * jcov.solve(p, jnp.asarray(X))))

    want, _ = ravel_pytree(jax.jit(jax.grad(jfun))(jp))
    tp = convert.matnormal_params_from_jax(jp, device="cpu")
    flat, unravel = tutils.ravel(tp)
    flat.requires_grad_(True)
    p = unravel(flat)
    out = (tcov.logdet(p) + tcov.logp(p)
           + torch.sum(_t(X) * tcov.solve(p, _t(X))))
    got, = torch.autograd.grad(out, flat)
    _close(got, want, GRAD_RTOL)


def test_cov_dense_oracles():
    """The JAX tests' dense checks on the port alone: logdet and solve
    against dense linear algebra, AR(1)'s closed form and block
    boundary, the masked Kronecker logdet and solve on the masked
    Cholesky factor."""
    rng = np.random.RandomState(0)
    cov = tcovs.CovAR1(6, rho=0.4, sigma=1.3)
    p = cov.init_params()
    prec = cov.prec(p).numpy()
    assert np.allclose(prec, np.triu(np.tril(prec, 1), -1))
    _close(cov.logdet(p), 6 * 2 * np.log(1.3) - np.log(1 - 0.4 ** 2))
    cov = tcovs.CovAR1(6, rho=0.3, sigma=1.0, scan_onsets=[0, 3])
    prec = cov.prec(cov.init_params()).numpy()
    assert prec[2, 3] == 0 and prec[3, 2] == 0
    sig = [_spd(n, rng) for n in (2, 3)]
    mask = np.array([1, 0, 1, 1, 1, 0])
    cov = tcovs.CovKroneckerFactored([2, 3], Sigmas=sig, mask=mask)
    p = cov.init_params()
    L = np.linalg.cholesky(np.kron(*sig))
    idx = np.flatnonzero(mask)
    sub = L[np.ix_(idx, idx)]
    _close(cov.logdet(p), np.linalg.slogdet(sub @ sub.T)[1], 1e-9)
    X = rng.randn(6, 2)
    got = cov.solve(p, _t(X)).numpy()
    _close(got[idx], np.linalg.solve(sub @ sub.T, X[idx]), 1e-9)
    assert np.all(got[mask == 0] == 0)


def test_cov_validation():
    base = tcovs.CovBase(3)
    with pytest.raises(NotImplementedError):
        base.logdet({})
    with pytest.raises(NotImplementedError):
        base.solve({}, torch.zeros(3, 1))
    with pytest.raises(RuntimeError):
        tcovs.CovUnconstrainedCholesky()
    with pytest.raises(RuntimeError):
        tcovs.CovUnconstrainedCholesky(size=3, Sigma=np.eye(3))
    with pytest.raises(RuntimeError):
        tcovs.CovUnconstrainedInvCholesky()
    with pytest.raises(TypeError):
        tcovs.CovKroneckerFactored((2, 3))


# -- likelihoods -------------------------------------------------------------

def _lik_setup(kind):
    """(jax fn, torch fn, x, [(jcov, tcov, jparams)] ...): the
    covariances a likelihood kind takes, with A where it has one."""
    rng = np.random.RandomState(21)
    n_t, n_v, k = 8, 6, 2
    x = rng.randn(n_t, n_v)
    row = jcovs.CovAR1(n_t, scan_onsets=[0, 4])
    col = jcovs.CovUnconstrainedCholesky(Sigma=_spd(n_v, rng))
    covs = [(row, row.init_params(seed=1)), (col, col.init_params(seed=2))]
    if kind in ("marginal_row", "conditional_row"):
        a = rng.randn(n_t, k)
    elif kind in ("marginal_col", "conditional_col"):
        a = rng.randn(n_v, k)
    if kind.startswith("conditional"):
        a = 0.05 * a
    if kind != "plain":
        q = jcovs.CovUnconstrainedCholesky(Sigma=_spd(k, rng))
        covs.append((q, q.init_params()))
    return x, (None if kind == "plain" else a), covs


LIK_KINDS = ["plain", "marginal_row", "marginal_col", "conditional_row",
             "conditional_col"]


def _lik_name(kind):
    return "matnorm_logp" if kind == "plain" else "matnorm_logp_" + kind


def _call(mod, kind, x, a, covs, params):
    args = [x]
    for (cov, _), p in zip(covs[:2], params[:2]):
        args += [cov, p]
    if a is not None:
        args += [a, covs[2][0], params[2]]
    return getattr(mod, _lik_name(kind))(*args)


@pytest.fixture(scope="module")
def lik_refs():
    """Each kind's setup and the JAX package's value and gradient (with
    respect to x, A and the parameters), and the two ``solve_det_*``,
    from one jitted program."""
    setups = {kind: _lik_setup(kind) for kind in LIK_KINDS}

    def value_and_grads(args):
        out = {}
        for kind, (x, a, jc) in args.items():
            covs = setups[kind][2]

            def fun(x, a, params):
                return _call(jlik, kind, x, a, covs, params)

            out[kind] = jax.value_and_grad(
                fun, argnums=(0, 2) if a is None else (0, 1, 2))(x, a, jc)
        for which in ("marginal", "conditional"):
            x, a, params = args[which + "_row"]
            (sig, _), _, (q, _) = setups[which + "_row"][2]
            out["solve_det_" + which] = getattr(
                jlik, "solve_det_" + which)(x, sig, params[0], a, q,
                                            params[2])
        return out

    args = {kind: (jnp.asarray(x), None if a is None else jnp.asarray(a),
                   [p for _, p in jc])
            for kind, (x, a, jc) in setups.items()}
    return setups, jax.jit(value_and_grads)(args)


@pytest.mark.parametrize("kind", LIK_KINDS)
def test_likelihood_and_gradient_match_jax(kind, lik_refs):
    setups, refs = lik_refs
    x, a, jc = setups[kind]
    want, wgrad = refs[kind]
    tc = [(convert.matnormal_cov_from_jax(c), p) for c, p in jc]
    tx = _t(x).requires_grad_(True)
    ta = None if a is None else _t(a).requires_grad_(True)
    tparams = convert.matnormal_params_from_jax([p for _, p in jc],
                                                device="cpu")
    flat, unravel = tutils.ravel(tparams)
    flat.requires_grad_(True)
    got = _call(tlik, kind, tx, ta, tc, unravel(flat))
    _close(got, want)
    grads = torch.autograd.grad(got, [tx] + ([] if a is None else [ta])
                                + [flat])
    for g, w in zip(grads[:-1], wgrad[:-1]):
        _close(g, w, GRAD_RTOL)
    _close(grads[-1], ravel_pytree(wgrad[-1])[0], GRAD_RTOL)


@pytest.mark.parametrize("which", ["marginal", "conditional"])
def test_solve_det_matches_jax(which, lik_refs):
    setups, refs = lik_refs
    x, a, jc = setups[which + "_row"]
    (sig, sp), _, (q, qp) = jc
    got = getattr(tlik, "solve_det_" + which)(
        _t(x), convert.matnormal_cov_from_jax(sig),
        convert.matnormal_params_from_jax(sp, device="cpu"), _t(a),
        convert.matnormal_cov_from_jax(q),
        convert.matnormal_params_from_jax(qp, device="cpu"))
    for g, w in zip(got, refs["solve_det_" + which]):
        _close(g, w)


def _dense_mn_logp(X, R, C):
    n, m = X.shape
    tr = np.trace(np.linalg.solve(C, X.T) @ np.linalg.solve(R, X))
    return -0.5 * (n * m * np.log(2 * np.pi) + m * np.linalg.slogdet(R)[1]
                   + n * np.linalg.slogdet(C)[1] + tr)


def test_likelihoods_match_dense_oracles():
    """The JAX tests' dense oracles (``tests/matnormal/test_matnormal.py``
    seeds' kind) on the port alone."""
    rng = np.random.RandomState(0)
    R, C = _spd(6, rng), _spd(4, rng)
    A, Q = rng.randn(6, 2), _spd(2, rng)
    X = tutils.rmn(R, C, random_state=1)
    r = tcovs.CovUnconstrainedCholesky(Sigma=R)
    c = tcovs.CovUnconstrainedCholesky(Sigma=C)
    q = tcovs.CovUnconstrainedCholesky(Sigma=Q)
    rp, cp, qp = r.init_params(), c.init_params(), q.init_params()
    _close(tlik.matnorm_logp(_t(X), r, rp, c, cp), _dense_mn_logp(X, R, C),
           1e-9)
    _close(tlik.matnorm_logp_marginal_row(_t(X), r, rp, c, cp, _t(A), q, qp),
           _dense_mn_logp(X, R + A @ Q @ A.T, C), 1e-9)
    A2 = rng.randn(4, 2)
    _close(tlik.matnorm_logp_marginal_col(_t(X), r, rp, c, cp, _t(A2), q,
                                          qp),
           _dense_mn_logp(X, R, C + A2 @ Q @ A2.T), 1e-9)


def test_masked_density_counts_observed_columns():
    """With a masked Kronecker column covariance the port's density is
    the dense density of the observed columns; the JAX package's counts
    every column, which is the port's plus a term in the row
    covariance's log-determinant alone, unbounded along the scale that
    the row and column covariances trade."""
    rng = np.random.RandomState(5)
    n_t, sizes = 10, [2, 3]
    mask = np.array([1, 1, 0, 1, 0, 1])
    x = rng.randn(n_t, 6)
    row = jcovs.CovIsotropic(n_t, var=1.7)
    sig = [_spd(n, rng) for n in sizes]
    col = jcovs.CovKroneckerFactored(sizes, Sigmas=sig, mask=mask)
    rp, cp = row.init_params(), col.init_params()
    trow = convert.matnormal_cov_from_jax(row)
    tcol = convert.matnormal_cov_from_jax(col)

    def port(rp, cp):
        return float(tlik.matnorm_logp(
            _t(x), trow, convert.matnormal_params_from_jax(rp, device="cpu"),
            tcol, convert.matnormal_params_from_jax(cp, device="cpu")))

    idx = np.flatnonzero(mask)
    L = np.linalg.cholesky(np.kron(*sig))[np.ix_(idx, idx)]
    _close(port(rp, cp), _dense_mn_logp(x[:, idx], 1.7 * np.eye(n_t),
                                        L @ L.T), 1e-9)
    hidden = 6 - idx.size
    want = float(jlik.matnorm_logp(jnp.asarray(x), row, rp, col, cp))
    extra = -0.5 * hidden * (n_t * np.log(2 * np.pi) + float(row.logdet(rp)))
    _close(port(rp, cp) + extra, want)

    def scaled(a):
        """The row covariance times a, each column factor times
        a^(-1/4): the Kronecker product of the two unchanged."""
        c = a ** -0.25
        flats = []
        for f, n in zip(cp["L_flats"], sizes):
            f = np.array(f)
            diag = np.cumsum(np.r_[0, np.arange(2, n + 1)])
            off = np.setdiff1d(np.arange(f.size), diag)
            f[off] *= c
            f[diag] += np.log(c)
            flats.append(jnp.asarray(f))
        return {"log_var": rp["log_var"] + np.log(a)}, {"L_flats": flats}

    ports = [port(*scaled(a)) for a in (1.0, 1e-2, 1e-4)]
    jaxs = [float(jlik.matnorm_logp(jnp.asarray(x), row, s[0], col, s[1]))
            for s in map(scaled, (1.0, 1e-2, 1e-4))]
    np.testing.assert_allclose(ports, ports[0], rtol=1e-9)
    assert jaxs[2] - jaxs[1] > 0.5 * hidden * n_t * np.log(100) * 0.99


# -- helpers -----------------------------------------------------------------

def test_parity_helpers():
    rng = np.random.RandomState(0)
    x = rng.randn(4, 3)
    flat = rng.randn(21)
    want = jax.jit(lambda x, f: (
        jutils.xx_t(x), jutils.x_tx(x), jutils.scaled_I(2.5, 3),
        jutils.unflatten_cholesky_unique(f, 6)))(jnp.asarray(x),
                                                  jnp.asarray(flat))
    L = tutils.unflatten_cholesky_unique(_t(flat), 6)
    for got, w in zip((tutils.xx_t(_t(x)), tutils.x_tx(_t(x)),
                       tutils.scaled_I(2.5, 3), L), want):
        _close(got, w)
    assert tutils.scaled_I(_t(2.5), 3).dtype == F64
    assert tutils.tril_size(5) == jutils.tril_size(5) == 15
    _close(tutils.flatten_cholesky_unique(L.numpy()),
           jutils.flatten_cholesky_unique(L.numpy()))
    _close(tutils.flatten_cholesky_unique(L.numpy()), flat, 1e-12)


def test_rmn_is_the_jax_packages_draw():
    rng = np.random.RandomState(3)
    R, C = _spd(5, rng), _spd(4, rng)
    assert np.array_equal(tutils.rmn(R, C, random_state=7),
                          jutils.rmn(R, C, random_state=7))


def test_unflatten_cholesky_gradient():
    flat = _t(np.random.RandomState(1).randn(6)).requires_grad_(True)

    def fun(f):
        L = tutils.unflatten_cholesky_unique(f, 3)
        return L @ L.T

    assert torch.autograd.gradcheck(fun, (flat,))


def test_ravel_is_ravel_pytree_order():
    """The flat vector of a parameter tree is ``ravel_pytree``'s entry
    for entry, and ``unravel`` inverts ``ravel``."""
    rng = np.random.RandomState(2)
    tree = {"time": {"rho_unc": rng.randn(1), "log_sigma": rng.randn(1)},
            "beta": rng.randn(3, 4),
            "space": {"L_flats": [rng.randn(3), rng.randn(6)]},
            "X_0": rng.randn(2, 2), "L_flat": rng.randn(3)}
    want, _ = ravel_pytree(jax.tree_util.tree_map(jnp.asarray, tree))
    flat, unravel = tutils.ravel(tutils.place(tree, F64))
    assert torch.equal(flat, _t(want))
    back = unravel(flat * 2)
    assert torch.equal(back["space"]["L_flats"][1], _t(tree["space"]
                                                       ["L_flats"][1]) * 2)
    assert back["beta"].shape == (3, 4)
    assert list(back) == sorted(tree)


def test_make_val_and_grad_scipy_bridge():
    """The scipy bridge gives the JAX package's value and gradient and
    drives ``scipy.optimize.minimize(jac=True)`` to the optimum."""
    from scipy.optimize import minimize

    rng = np.random.RandomState(0)
    a, b = _spd(4, rng), rng.randn(4)
    ta, tb = _t(a), _t(b)

    vg = tutils.make_val_and_grad(lambda x: 0.5 * x @ ta @ x - tb @ x,
                                  device="cpu")
    jvg = jutils.make_val_and_grad(
        lambda x: 0.5 * x @ jnp.asarray(a) @ x - jnp.asarray(b) @ x)
    x0 = rng.randn(4)
    val, grad = vg(x0)
    jval, jgrad = jvg(x0)
    assert isinstance(val, float)
    assert grad.dtype == np.float64
    _close(val, jval)
    _close(grad, jgrad)
    res = minimize(vg, np.zeros(4), jac=True, method='L-BFGS-B')
    np.testing.assert_allclose(res.x, np.linalg.solve(a, b), atol=1e-5)


# -- estimators --------------------------------------------------------------

def _regression_data():   # tests/matnormal/test_matnormal.py's
    n_t, n_c, n_v = 120, 3, 8
    rng = np.random.RandomState(2)
    X = rng.randn(n_t, n_c)
    beta = rng.randn(n_c, n_v)
    Y = X @ beta + 0.1 * rng.randn(n_t, n_v)
    return X, Y, beta


def test_regression_matches_jax():
    """At the JAX test's data, with an AR(1) time and a diagonal space
    covariance (the JAX test's are the identity and isotropic: these
    hold the AR(1) and per-voxel parameters too)."""
    X, Y, _ = _regression_data()
    jm = JRegression(jcovs.CovAR1(120, scan_onsets=[0, 60]),
                     jcovs.CovDiagonal(8), max_iters=600).fit(X, Y)
    tm = MatnormalRegression(tcovs.CovAR1(120, scan_onsets=[0, 60]),
                             tcovs.CovDiagonal(8), max_iters=600,
                             device="cpu")
    tm._fit(X, Y, True, F64)
    assert abs(tm.final_loss_ - jm.final_loss_) <= 1e-6 * abs(jm.final_loss_)
    np.testing.assert_allclose(tm.beta_, jm.beta_, rtol=0,
                               atol=1e-4 * np.abs(jm.beta_).max())
    for tp, jp in ((tm.time_params_, jm.time_params_),
                   (tm.space_params_, jm.space_params_)):
        for k in jp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=0, atol=1e-4)
    conv = convert.matnormal_regression_from_jax(jm, device="cpu")
    _close(conv.predict(X), jm.predict(X))
    _close(conv.calibrate(Y), jm.calibrate(Y))
    assert conv.final_loss_ == jm.final_loss_


def test_regression_recovers_beta():
    """The JAX test's bars on the port's float32 fit."""
    X, Y, beta = _regression_data()
    model = MatnormalRegression(tcovs.CovIdentity(120), tcovs.CovIsotropic(8),
                                device="cpu").fit(X, Y)
    assert model.beta_.dtype == np.float32
    assert np.allclose(model.beta_, beta, atol=0.1)
    assert np.corrcoef(model.predict(X).ravel(), Y.ravel())[0, 1] > 0.99
    X_hat = model.calibrate(Y)
    assert np.corrcoef(X_hat.ravel(), X.ravel())[0, 1] > 0.9


def test_regression_masked_space_fit():
    """A masked Kronecker space covariance fits (the JAX package's
    regression cannot trace its mask): finite loss, beta recovered on
    the kept voxels, and the loss at the optimum bounded."""
    rng = np.random.RandomState(4)
    n_t, n_c, sizes = 60, 2, [2, 3, 2]
    mask = np.array([1, 1, 0, 1, 1, 1, 0, 1, 1, 0, 1, 1])
    X = rng.randn(n_t, n_c)
    beta = rng.randn(n_c, 12)
    Y = X @ beta + 0.2 * rng.randn(n_t, 12)
    model = MatnormalRegression(
        tcovs.CovAR1(n_t), tcovs.CovKroneckerFactored(sizes, mask=mask),
        device="cpu")
    model._fit(X, Y, True, F64)
    assert np.isfinite(model.final_loss_)
    keep = mask == 1
    assert np.allclose(model.beta_[:, keep], beta[:, keep], atol=0.1)
    assert np.corrcoef(model.calibrate(Y).ravel(), X.ravel())[0, 1] > 0.9


def _mnrsa_data():   # tests/matnormal/test_matnormal.py's
    n_t, n_c, n_v = 150, 4, 12
    rng = np.random.RandomState(3)
    U = np.array([[1.0, 0.8, 0.0, 0.0],
                  [0.8, 1.0, 0.0, 0.0],
                  [0.0, 0.0, 1.0, 0.8],
                  [0.0, 0.0, 0.8, 1.0]])
    X = rng.randn(n_t, n_c)
    W = np.linalg.cholesky(U) @ rng.randn(n_c, n_v)
    Y = X @ W + 0.5 * rng.randn(n_t, n_v)
    return X, Y, U, n_t, n_v


def test_mnrsa_matches_jax():
    X, Y, _, n_t, n_v = _mnrsa_data()
    kw = dict(n_nureg=2, max_iters=600)
    jm = JMNRSA(time_cov=jcovs.CovIdentity(n_t),
                space_cov=jcovs.CovIsotropic(n_v), **kw).fit(Y, X)
    tm = MNRSA(time_cov=tcovs.CovIdentity(n_t),
               space_cov=tcovs.CovIsotropic(n_v), device="cpu", **kw)
    tm._fit(Y, X, True, F64)
    _close(tm.naive_U_, jm.naive_U_, 1e-9)
    assert abs(tm.final_loss_ - jm.final_loss_) <= 1e-6 * abs(jm.final_loss_)
    for name in ("U_", "L_"):
        np.testing.assert_allclose(getattr(tm, name), getattr(jm, name),
                                   rtol=0, atol=1e-3 * np.abs(jm.U_).max())
    np.testing.assert_allclose(tm.C_, jm.C_, rtol=0, atol=1e-3)
    np.testing.assert_allclose(tm.space_params_["log_var"].numpy(),
                               np.asarray(jm.space_params_["log_var"]),
                               rtol=0, atol=1e-4)
    conv = convert.mnrsa_from_jax(jm, device="cpu")
    for name in ("U_", "C_", "L_", "X_0_", "naive_U_"):
        assert np.array_equal(getattr(conv, name), getattr(jm, name))
    assert conv.final_loss_ == jm.final_loss_


def test_mnrsa_recovers_rsa_structure():
    """The JAX test's bar on the port's float32 fit (300 iterations)."""
    X, Y, U, n_t, n_v = _mnrsa_data()
    model = MNRSA(time_cov=tcovs.CovIdentity(n_t),
                  space_cov=tcovs.CovIsotropic(n_v), n_nureg=2,
                  device="cpu").fit(Y, X)
    assert model.U_.shape == (4, 4)
    iu = np.triu_indices(4, 1)
    assert np.corrcoef(model.C_[iu], U[iu])[0, 1] > 0.7
    assert np.isfinite(model.final_loss_)


def test_estimator_params_and_not_fitted():
    model = MatnormalRegression(tcovs.CovIdentity(4), tcovs.CovIsotropic(3),
                                device="cpu")
    params = model.get_params()
    assert params["max_iters"] == 300 and params["device"] == "cpu"
    model.set_params(max_iters=5)
    assert model.max_iters == 5
    with pytest.raises(ValueError):
        model.set_params(bogus=1)
    with pytest.raises(NotFittedError):
        model.predict(np.zeros((4, 2)))
    rsa = MNRSA(tcovs.CovIdentity(4), tcovs.CovIsotropic(3), device="cpu")
    assert rsa.get_params()["n_nureg"] == 5


def test_cuda_default_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    X, Y, _ = _regression_data()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MatnormalRegression(tcovs.CovIdentity(120),
                            tcovs.CovIsotropic(8)).fit(X, Y)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MNRSA(tcovs.CovIdentity(120), tcovs.CovIsotropic(8)).fit(Y, X)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tutils.make_val_and_grad(lambda x: x.sum())
