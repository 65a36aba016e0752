"""Host ms a frame in the assemble span (greedy people assembly)."""

from perfbench import readers

UNIT = "ms"


def read(run):
    return readers.host_ms_per_frame(run, "assemble")
