"""Model, training: device ms a step in the program's span
``train.forward`` (the loss, remat's first pass): its CUDA events'
interval, which holds any time the device waits inside the span for the
host (``idle_share.train`` gives the traced steps' idle)."""

from benchkit.spans import device_ms


def read(run):
    return device_ms(run, "train.forward")
