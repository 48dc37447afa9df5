"""Device idle ms a traced frame while the host was inside a key frame's
stage of ``run_batched`` (the outermost ``sdaof.pixel.key`` range open
at each idle gap's midpoint; ``harness/stages.py``)."""

from portbench.harness.stages import idle_ms_per_frame


def read(rec):
    return idle_ms_per_frame(rec, "key")
