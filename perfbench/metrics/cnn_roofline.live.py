"""The body CNN's share of its roofline: its FLOPs over the device time
launched in the net_outputs span, against the bf16 peak.
"""

from perfbench import readers

UNIT = "%"


def read(run):
    return readers.cnn_roofline(run)
