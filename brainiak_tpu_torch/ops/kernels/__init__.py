"""Hand-written CUDA kernels: the build (:mod:`._build`), the ingest
epoch normalization (:mod:`.epoch_norm`, kernel K2) and the SUMMA
ring step (:mod:`.ring`, kernel K5)."""
