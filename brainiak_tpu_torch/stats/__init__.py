"""Resampling statistics of the port: surrogate families, mergeable
null accumulators, and the chunked, resumable, poolable
:class:`NullEngine`.

Submodules
----------
- :mod:`.pvalues`    p-value / summary-statistic conventions (NumPy)
- :mod:`.surrogates` surrogate-family registry + batched programs
- :mod:`.accum`      mergeable null accumulators (NumPy)
- :mod:`.engine`     :class:`NullEngine` + :class:`NullDistribution`

Attribute access is lazy (PEP 562): importing
``brainiak_tpu_torch.stats.pvalues`` alone loads neither the engine
nor the surrogate programs.
"""

__all__ = [
    "FAMILIES",
    "NullAccumulator",
    "NullDistribution",
    "NullEngine",
    "TRANSFORMS",
    "compute_summary_statistic",
    "default_null_batch",
    "fdr_threshold",
    "make_spec",
    "p_from_null",
    "stats_budget_bytes",
]

_EXPORTS = {
    "FAMILIES": ".surrogates",
    "TRANSFORMS": ".surrogates",
    "make_spec": ".surrogates",
    "NullAccumulator": ".accum",
    "fdr_threshold": ".accum",
    "NullDistribution": ".engine",
    "NullEngine": ".engine",
    "default_null_batch": ".engine",
    "stats_budget_bytes": ".engine",
    "compute_summary_statistic": ".pvalues",
    "p_from_null": ".pvalues",
}


def __getattr__(name):
    target = _EXPORTS.get(name)
    if target is None:
        raise AttributeError(
            "module {!r} has no attribute {!r}".format(__name__, name))
    from importlib import import_module
    return getattr(import_module(target, __name__), name)


def __dir__():
    return sorted(set(globals()) | set(__all__))
