"""Model, training: device ms a step in the program's span
``train.optimizer`` (AdamW's update with its fp32 moments, and its
application): its CUDA events' interval, idle inside the span included."""

from benchkit.spans import device_ms


def read(run):
    return device_ms(run, "train.optimizer")
