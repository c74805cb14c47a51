"""k-means++ seeding and Lloyd iterations on tensors.

The JAX package seeds TFA's factor centres with sklearn's
``KMeans(init='k-means++', n_init=10, random_state=100)``; the port
imports no sklearn (the card's machine has none), so this is its own
k-means of the same kind: sklearn's greedy k-means++ (``2 + log K``
candidate draws a centre, the one that lowers the potential most
kept), then Lloyd iterations until the labels stop changing or the
centres move less than ``tol`` times the mean coordinate variance, the
best of ``n_init`` runs by inertia.  The draws come from one
``np.random.RandomState(random_state)`` on the host, so a run is
deterministic, but they are not sklearn's draws.

The ``n_init`` runs' Lloyd iterations are batched: one [n_init, n, K]
distance tensor an iteration, the centre sums by a one-hot product
(deterministic, unlike an atomic scatter), a run that has converged
frozen by ``torch.where``, and one host read an iteration.  An empty
cluster keeps its centre (sklearn moves it to a far point).
"""

import math

import numpy as np
import torch

__all__ = ["kmeans"]


def _sq_dist(x, x_sq, c):
    """Squared distances [..., n, K] of the rows of ``x`` [n, d] to
    centres ``c`` [..., K, d], clamped at 0."""
    d = x_sq[:, None] - 2.0 * x @ c.transpose(-1, -2) \
        + (c * c).sum(dim=-1)[..., None, :]
    return torch.clamp(d, min=0.0)


def _plusplus(x, x_sq, k, rng):
    """sklearn's greedy k-means++ seeding of ``k`` centres from the
    rows of ``x``; the host draws all of a run's random numbers up
    front, the potentials stay on the device."""
    n = x.shape[0]
    trials = 2 + int(math.log(k))
    first = rng.randint(n)
    draws = torch.as_tensor(rng.uniform(size=(k - 1, trials)),
                            dtype=x.dtype, device=x.device)
    ids = [torch.tensor(first, device=x.device)]
    closest = _sq_dist(x, x_sq, x[first][None])[:, 0]
    pot = closest.sum()
    for c in range(1, k):
        cum = torch.cumsum(closest, dim=0)
        cand = torch.clamp(torch.searchsorted(cum, draws[c - 1] * pot),
                           max=n - 1)
        dist = torch.minimum(closest[None, :],
                             _sq_dist(x, x_sq, x[cand]).T)
        pots = dist.sum(dim=1)
        best = torch.argmin(pots)
        pot = pots[best]
        closest = dist[best]
        ids.append(cand[best])
    return x[torch.stack(ids)]


def kmeans(X, n_clusters, n_init=10, random_state=100, max_iter=300,
           tol=1e-4, device="cpu", dtype=torch.float64):
    """k-means of the rows of ``X`` [n, d] (numpy or tensor) into
    ``n_clusters``: ``(centres [K, d] numpy float64, inertia)``, the
    best of ``n_init`` k-means++ seeded runs (see the module
    docstring), computed in ``dtype`` on ``device``."""
    x = torch.as_tensor(np.asarray(X), dtype=dtype, device=device)
    mean = x.mean(dim=0)
    x = x - mean
    x_sq = (x * x).sum(dim=1)
    tol = float(x.var(dim=0, unbiased=False).mean()) * tol
    rng = np.random.RandomState(random_state)
    k = n_clusters
    c = torch.stack([_plusplus(x, x_sq, k, rng) for _ in range(n_init)])
    active = torch.ones(n_init, dtype=torch.bool, device=x.device)
    old = torch.full((n_init, x.shape[0]), -1, dtype=torch.long,
                     device=x.device)
    for _ in range(max_iter):
        labels = _sq_dist(x, x_sq, c).argmin(dim=-1)
        onehot = torch.nn.functional.one_hot(labels, k).to(dtype)
        counts = onehot.sum(dim=1)[..., None]
        sums = onehot.transpose(1, 2) @ x
        new = torch.where(counts > 0, sums / torch.clamp(counts, min=1),
                          c)
        shift = ((new - c) ** 2).sum(dim=(1, 2))
        c = torch.where(active[:, None, None], new, c)
        done = (labels == old).all(dim=1) | (shift <= tol)
        active = active & ~done
        old = labels
        if not bool(active.any()):
            break
    inertia = _sq_dist(x, x_sq, c).min(dim=-1).values.sum(dim=1)
    best = int(torch.argmin(inertia))
    return ((c[best] + mean).cpu().numpy().astype(np.float64),
            float(inertia[best]))
