"""TPE-style Bayesian hyperparameter optimization.

Port of ``brainiak_tpu/hyperparamopt/hpo.py`` (Bergstra et al.
2011/2013), a verbatim NumPy and SciPy copy: per-variable 1-D
Gaussian-mixture models over the best 15% and remaining trials;
candidates sampled from the "good" mixture are scored by the
likelihood ratio (expected improvement) and the best not-too-close
candidate is evaluated next.  It draws from NumPy's global generator
as the JAX package does, so one ``np.random.seed`` gives one trial
list in both packages.  The losses are whatever the caller runs: on
the card, a port estimator's fit and score.
"""

import logging

import numpy as np
from scipy.special import erf
import scipy.stats as st

logger = logging.getLogger(__name__)

__all__ = ["fmin", "get_next_sample", "get_sigma", "gmm_1d_distribution"]


def get_sigma(x, min_limit=-np.inf, max_limit=np.inf):
    """Per-point bandwidths: distance to the farthest of the two nearest
    neighbors (including the limits) (reference hpo.py:46-85)."""
    z = np.append(x, [min_limit, max_limit])
    sigma = np.ones(x.shape)
    for i in range(x.size):
        left_gaps = np.where(z < x[i], x[i] - z, np.inf)
        right_gaps = np.where(z > x[i], z - x[i], np.inf)
        xleft_gap = left_gaps.min()
        xright_gap = right_gaps.min()
        sigma[i] = max(xleft_gap, xright_gap)
        if sigma[i] == np.inf:
            sigma[i] = min(xleft_gap, xright_gap)
        if sigma[i] == -np.inf:  # should never happen
            sigma[i] = 1.0
    return sigma


class gmm_1d_distribution:
    """Truncated 1-D Gaussian mixture over a set of points
    (reference hpo.py:89-218).

    Parameters: points ``x``, truncation limits, optional per-point
    weights.  Callable returns the pdf at scalar or array inputs;
    ``get_samples`` draws truncated samples.
    """

    def __init__(self, x, min_limit=-np.inf, max_limit=np.inf,
                 weights=1.0):
        self.points = x
        self.N = x.size
        self.min_limit = min_limit
        self.max_limit = max_limit
        self.sigma = get_sigma(x, min_limit=min_limit,
                               max_limit=max_limit)
        self.weights = (
            2 / (erf((max_limit - x) / (np.sqrt(2.) * self.sigma))
                 - erf((min_limit - x) / (np.sqrt(2.) * self.sigma)))
            * weights)
        self.W_sum = np.sum(self.weights)

    def __call__(self, x):
        scalar = np.isscalar(x)
        xv = np.atleast_1d(np.asarray(x, dtype=float))
        z = (xv[:, None] - self.points[None, :]) / self.sigma[None, :]
        pdf = np.exp(-0.5 * z ** 2) / (np.sqrt(2 * np.pi)
                                       * self.sigma[None, :])
        y = (pdf * self.weights[None, :]).sum(axis=1) / self.W_sum
        y = np.where((xv < self.min_limit) | (xv > self.max_limit), 0.0, y)
        return float(y[0]) if scalar else y

    def get_gmm_pdf(self, x):
        return self.__call__(x)

    def get_samples(self, n):
        """Draw n truncated samples via rejection on the mixture."""
        normalized_w = self.weights / np.sum(self.weights)
        samples = np.zeros(n)
        k = 0
        while k < n:
            idx = st.rv_discrete(
                values=(range(self.N), normalized_w)).rvs(size=n - k)
            draws = np.random.normal(loc=self.points[idx],
                                     scale=self.sigma[idx])
            valid = draws[(draws >= self.min_limit)
                          & (draws <= self.max_limit)]
            take = min(len(valid), n - k)
            samples[k:k + take] = valid[:take]
            k += take
        return samples


def get_next_sample(x, y, min_limit=-np.inf, max_limit=np.inf):
    """Expected-improvement candidate from the good/rest GMM likelihood
    ratio (reference hpo.py:221-280)."""
    order = np.argsort(y)
    xs, ys = np.asarray(x)[order], np.asarray(y)[order]
    n = ys.shape[0]
    g = int(np.round(np.ceil(0.15 * n)))
    lx_pts, ly = xs[:g], ys[:g]
    gx_pts = xs[g:n]
    lymin, lymax = ly.min(), ly.max()
    weights = ((lymax - ly) / (lymax - lymin)) if lymax > lymin \
        else np.ones_like(ly)
    lx = gmm_1d_distribution(lx_pts, min_limit=min_limit,
                             max_limit=max_limit, weights=weights)
    gx = gmm_1d_distribution(gx_pts, min_limit=min_limit,
                             max_limit=max_limit)

    samples = lx.get_samples(n=1000)
    ei = lx(samples) / gx(samples)

    # avoid re-sampling points too close to previous trials
    h = (x.max() - x.min()) / (10 * x.size)
    s = 0
    while np.abs(x - samples[ei.argmax()]).min() < h:
        ei[ei.argmax()] = 0
        s += 1
        if s == samples.size:
            break
    return samples[ei.argmax()]


def fmin(loss_fn, space, max_evals, trials, init_random_evals=30,
         explore_prob=0.2):
    """Minimize ``loss_fn`` over the given 1-D-per-variable space
    (reference hpo.py:282-374).

    space : dict of {name: {'dist': scipy frozen dist, 'lo':, 'hi':}}
    trials : list accumulating {'<var>':…, 'loss':…} dicts (may be
        pre-seeded).
    Returns the best trial dict.
    """
    for s in space:
        if not hasattr(space[s]['dist'], 'rvs'):
            raise ValueError('Unknown distribution type for variable')
        space[s].setdefault('lo', -np.inf)
        space[s].setdefault('hi', np.inf)

    if len(trials) > init_random_evals:
        init_random_evals = 0

    for t in range(max_evals):
        sdict = {}
        use_random_sampling = (t < init_random_evals
                               or np.random.random() <= explore_prob)
        yarray = np.array([tr['loss'] for tr in trials])
        for s in space:
            if use_random_sampling:
                sdict[s] = space[s]['dist'].rvs()
            else:
                sarray = np.array([tr[s] for tr in trials])
                sdict[s] = get_next_sample(sarray, yarray,
                                           min_limit=space[s]['lo'],
                                           max_limit=space[s]['hi'])
        logger.debug('%s next point %d = %s',
                     'Explore' if use_random_sampling else 'Exploit',
                     t, sdict)
        y = loss_fn(sdict)
        sdict['loss'] = y
        trials.append(sdict)

    yarray = np.array([tr['loss'] for tr in trials])
    best = trials[int(yarray.argmin())]
    logger.info('Best point so far = %s', best)
    return best
