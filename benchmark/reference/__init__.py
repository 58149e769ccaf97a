"""Plain reference of what the benchmark's cells compute.

PyTorch and NumPy only: nothing here imports the package under test, JAX or
the JAX package. It recomputes every layer the timed paths run from the
inputs the benchmark makes (the genome, the chunk files, the weights file,
the initial parameters and the seed), at float32, or at a lower precision
for the controls (`model.Precision`).
"""
