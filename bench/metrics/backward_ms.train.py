"""Model, training: device ms a step in the program's span
``train.backward`` (``torch.autograd.grad``: remat's recompute and the
gradients): its CUDA events' interval, idle inside the span included."""

from benchkit.spans import device_ms


def read(run):
    return device_ms(run, "train.backward")
