"""The help texts of the port's command line say what the port does today:
POD5 output, the packed wire formats (`--wire-format auto` starts at the ULP
tier, as in the JAX package), --num-shards and --trace-dir are ported, and
so are several devices: in one process, and over processes with `train --tp`."""

from __future__ import annotations

import torch_port_threads  # noqa: F401  (torch's threads: one share of the cores a worker)

import re

from click.testing import CliRunner

from seq2squiggle_tpu_torch import cli


def _squeeze(text: str) -> str:
    """Without whitespace: click wraps help text where it likes, at hyphens too."""
    return re.sub(r"\s+", "", text)


def _has(text: str, phrase: str) -> bool:
    return _squeeze(phrase) in _squeeze(text)


def _help(*args):
    result = CliRunner().invoke(cli.main, [*args, "--help"])
    assert result.exit_code == 0, result.output
    return result.output


def test_main_help_lists_what_is_and_is_not_ported():
    text = _help()
    assert "predict" in text and "train" in text
    assert _has(text, "writes BLOW5, SLOW5 or POD5")
    assert not _has(text, "POD5 output, --num-shards")  # the stale sentences
    assert not _has(text, "auto means raw int16 rows")
    assert not _has(text, "are not ported yet")
    assert _has(text, "--wire-format auto starts at the ULP tier")
    assert _has(text, "--num-shards and --trace-dir work")
    assert not _has(text, "Several devices in one process are not ported")  # the stale one
    assert _has(text, "Several devices work as in the JAX package")
    assert _has(text, "train data- and tensor-parallel (`train --tp`)")


def test_predict_help_and_the_hidden_wire_format_option():
    text = _help("predict")
    assert _has(text, "--wire-format auto starts at the ULP tier under bf16 compute")
    assert not _has(text, "auto or raw only")  # the stale sentence
    assert "--wire-format" not in text.split("Options:")[1]  # hidden until asked for
    shown = CliRunner().invoke(cli.main, ["predict", "--show-advanced-options"])
    assert shown.exit_code == 0, shown.output
    text = shown.output
    # the JAX package's help text (seq2squiggle_tpu/cli.py:134-143), now true here
    assert _has(text, "auto starts at the ULP tier")
    assert _has(text, "downgrades ulp -> event -> 8 -> 12-bit -> raw int16 on exception overflow")
    assert not _has(text, "not ported yet and are an error")
    assert _has(text, "Write a torch.profiler trace of the run here.")
