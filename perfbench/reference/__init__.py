"""The plain references the benchmark holds the program to.

Plain PyTorch only: nothing here imports ``jax``, the JAX package ``repro``
or anything of the port ``repro_torch``, and nothing takes what the program
made.  A configuration names its reference module (``"reference"``).
"""
