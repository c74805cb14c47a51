"""Host statistics helpers of the port, copied from the JAX package's
``brainiak_tpu/stats`` as the ported modules need them.  The resampling
engine (``NullEngine``) is not ported yet."""
