"""95th percentile of a frame's time from its upload to its keypoints on
the host.
"""

from perfbench import readers

UNIT = "ms"


def read(run):
    return readers.latency_ms(run, 95)
