"""The JAX package's host-side modules that the port reuses as they are.

None of them imports jax (tests/test_torch_port_simulate.py checks that in a
fresh process): config loading and checking, FASTA/FASTQ read sampling, the
chemistry profiles, chunk batching, streaming export, and the BLOW5/SLOW5
writer and reader. The port's run loop and chip_smoke.py take them from here,
so that neither names the JAX package.
"""

from seq2squiggle_tpu.config import check_model_config, load_config  # noqa: F401
from seq2squiggle_tpu.io.reads import get_reads  # noqa: F401
from seq2squiggle_tpu.io.slow5 import read_slow5  # noqa: F401
from seq2squiggle_tpu.io.writers import BLOW5Writer  # noqa: F401
from seq2squiggle_tpu.profiles import (  # noqa: F401
    get_profile,
    update_config_for_profile,
    update_profile,
)
from seq2squiggle_tpu.runtime.batcher import iter_batches  # noqa: F401
from seq2squiggle_tpu.runtime.exporter import StreamingExporter  # noqa: F401
