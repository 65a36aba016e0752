"""Device operations (kernels, copies, memsets) a frame in the traced
window.
"""

from perfbench import readers

UNIT = "launches"


def read(run):
    return readers.launches_per_frame(run)
