"""Set-up seconds: from the moment torch is imported and the CUDA device
found to the end of the warm pass, the card synchronized: importing the
port, the CUDA context, the inputs, the template banks, loading (or, in a
fresh checkout, building) the kernels, and one pass of the cell's own
traffic.  The interpreter's start, ``import torch`` and the driver's start
come before and are logged apart: they are not the program's."""


def read(run):
    return run.setup_s
