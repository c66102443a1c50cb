"""Training of the port: samplers, losses, the train loop, checkpoints and
the driver (``deepmerge_tpu/train`` in the JAX package)."""
