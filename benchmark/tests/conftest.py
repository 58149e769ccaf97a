"""The benchmark's tests import it as the package `benchmark`, from the
repository's root. Each test process keeps torch to two threads: several
pytest workers with a full thread pool each slow one another down many
times over."""

import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
torch.set_num_threads(2)
