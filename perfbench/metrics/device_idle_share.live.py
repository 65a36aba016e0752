"""Share of the traced window in which no kernel, copy or memset ran."""

from perfbench import readers

UNIT = "%"


def read(run):
    return readers.device_idle_share(run)
