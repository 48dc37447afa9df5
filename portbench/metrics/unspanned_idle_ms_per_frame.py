"""Device idle ms a traced frame while the host was inside no
``sdaof.pixel.*`` range: between clips, and code of the program no stage
covers (``harness/stages.py``). With the key and batch parts it sums to
the traced part's idle time a frame."""

from portbench.harness.stages import idle_ms_per_frame


def read(rec):
    return idle_ms_per_frame(rec, "unspanned")
