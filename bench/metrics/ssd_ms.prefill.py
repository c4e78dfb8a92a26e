"""Model, prefill: device ms a prefill in the program's span ``ssm.ssd``
(the SSD layer's chunked scan, all layers summed): the CUDA events'
interval, idle inside the spans included."""

from benchkit.spans import device_ms


def read(run):
    return device_ms(run, "ssm.ssd")
