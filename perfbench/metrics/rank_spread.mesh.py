"""Spread of the ranks' frames a second: (max - min) / mean."""

from perfbench import readers

UNIT = "%"


def read(run):
    return readers.rank_spread(run)
