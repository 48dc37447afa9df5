"""Device idle ms a traced frame while the host was inside a batch's
stages of ``run_batched`` (the outermost ``sdaof.pixel.flow`` /
``denoise`` / ``finalize`` / ``close`` range open at each idle gap's
midpoint; ``harness/stages.py``)."""

from portbench.harness.stages import idle_ms_per_frame


def read(rec):
    return idle_ms_per_frame(rec, "batch")
