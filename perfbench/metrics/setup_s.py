"""Set-up: from the process's start (imports, weights, inputs, the program,
the kernels' build, the warm-up pass over the pool) to the window.
"""

from perfbench import readers

UNIT = "s"


def read(run):
    return readers.setup_s(run)
