"""The benchmark of seq2squiggle_tpu_torch on NVIDIA GPUs (see run.py)."""
