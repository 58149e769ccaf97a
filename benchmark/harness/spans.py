"""The program's span recorder (seq2squiggle_tpu_torch/tracing.py), as the
train step's per-layer metrics read it. A program without the recorder, or
a run with it switched off, reads as nothing."""

from __future__ import annotations

from typing import List, Optional


def window_steps(run) -> Optional[List[object]]:
    """The `train.step` span of each of the window's untraced steps, or
    None. The window's steps are the last `run["steps"]` step spans the
    recorder holds: set-up's checked steps come before them, and the outputs
    check runs the reference alone. Those recorded while the profiler ran
    are the traced steps, and are left out."""
    try:
        from seq2squiggle_tpu_torch import tracing
    except ImportError:
        return None
    if not tracing.enabled() or not run.get("steps"):
        return None
    steps = [r for r in tracing.records() if r.name == "train.step"][-int(run["steps"]):]
    return [s for s in steps if not s.profiled] or None
