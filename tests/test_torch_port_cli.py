"""The help texts of the port's command line say what the port does today:
POD5 output is ported; the packed wire formats, --num-shards above 1 and
--trace-dir are not, and `--wire-format auto` means raw int16 rows."""

from __future__ import annotations

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
    assert not _has(text, "POD5 output, --num-shards")  # the stale sentence
    assert _has(text, "--wire-format auto means raw int16 rows")
    assert _has(text, "--num-shards above 1 and --trace-dir are not ported yet")


def test_predict_help_and_the_hidden_wire_format_option():
    text = _help("predict")
    assert _has(text, "--wire-format auto or raw only; both ship raw int16 rows")
    assert "--wire-format" not in text.split("Options:")[1]  # hidden until asked for
    shown = CliRunner().invoke(cli.main, ["predict", "--show-advanced-options"])
    assert shown.exit_code == 0, shown.output
    text = shown.output
    assert _has(text, "On the port auto and raw both ship raw int16 rows")
    assert _has(text, "not ported yet and are an error")
    assert not _has(text, "auto starts at the ULP tier")  # the JAX package's behaviour
