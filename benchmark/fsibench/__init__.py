"""The benchmark of the PyTorch/CUDA port (``particlemethod_fsi_tpu_torch``):
the harness, the traffic generator, the plain reference, the trace readers
and the roofline arithmetic.  Only :mod:`fsibench.program` imports the
port; nothing here imports ``jax`` or the JAX package."""
