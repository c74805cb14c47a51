"""Hand-written CUDA kernels: the build (:mod:`._build`) and the
ingest epoch normalization (:mod:`.epoch_norm`, kernel K2)."""
