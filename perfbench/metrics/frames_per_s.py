"""Frames whose keypoints reached the host in the window, a second, summed
over ranks.
"""

from perfbench import readers

UNIT = "frames/s"


def read(run):
    return readers.frames_per_s(run)
