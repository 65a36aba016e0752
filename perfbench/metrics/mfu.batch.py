"""The whole step's share of the bf16 peak: the FLOPs the frames' people
need over the traced window.
"""

from perfbench import readers

UNIT = "%"


def read(run):
    return readers.mfu(run)
