"""Device ms a frame launched in the decode span (resize-merge, NMS, the
fused PAF kernel).
"""

from perfbench import readers

UNIT = "ms"


def read(run):
    return readers.span_device_ms(run, "decode")
