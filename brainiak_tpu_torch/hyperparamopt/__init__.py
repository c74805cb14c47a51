"""Bayesian hyperparameter optimization (TPE-style): the port of
``brainiak_tpu/hyperparamopt``, host NumPy."""

from .hpo import (  # noqa: F401
    fmin,
    get_next_sample,
    get_sigma,
    gmm_1d_distribution,
)
