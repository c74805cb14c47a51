"""Host helpers of the port, copied from the JAX package's
``brainiak_tpu/utils`` as the ported modules need them."""
