"""Plain PyTorch references of the benchmark's model families.

Nothing here imports the program under test (``tfplus_tpu_torch``), JAX or
the JAX package: the references work everything out again from the inputs
that the harness makes from the seed.
"""
