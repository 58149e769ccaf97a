"""seq2squiggle-tpu on PyTorch and CUDA: the port of the `predict` path.

A second package beside the JAX one (`seq2squiggle_tpu`), for one NVIDIA
H100. It reuses the JAX package's host modules, which import no jax (FASTA
and read sampling, batching, streaming export, BLOW5 writers, profiles,
config), and ports everything that does: the model, the sampling, the
regulator, the device step and the run loop. The fused FFT-block kernel is
written by hand in CUDA C++ for sm_90a (csrc/fft_block.cu); every other
device op is plain PyTorch. Randomness reproduces jax.random's threefry
draws (prng.py), so a run matches the JAX package's for the same seed.

Entry point: `python -m seq2squiggle_tpu_torch predict ...`.
"""

from seq2squiggle_tpu import __version__  # noqa: F401  (one version for both)
