"""seq2squiggle-tpu on PyTorch and CUDA: the port of the JAX package's commands.

A second package beside the JAX one, for one NVIDIA H100. It imports torch,
never jax, and nothing of the JAX package: the host modules that need no
accelerator (FASTA and read sampling, batching, streaming export, BLOW5
writers, profiles, config, training data and metrics, preprocessing, the
sweep's search and the standardize-events tool) are the port's own copies
under the same relative names, and everything else is ported: the model, the
sampling, the regulator, the device step, the run loop, the losses, the
optimizers, the validation plots and the trainer. The kernels are written by hand in
CUDA C++ for sm_90a: the fused inference FFT block (csrc/fft_block.cu) and
the training attention core, forward and backward (csrc/attn_core.cu); every
other device op is plain PyTorch. Randomness reproduces jax.random's
threefry draws (prng.py), so a run matches the JAX package's for the same
seed.

Entry points: `python -m seq2squiggle_tpu_torch predict|preprocess|train|sweep|version
...` and `python -m seq2squiggle_tpu_torch.tools.standardize_events ...`.
"""

__version__ = "0.1.0"  # the JAX package's version string
