"""fwd_device_ms.train: the device time a training step of the port's span
``train.forward`` (the model's forward in train mode, the DB tail's
included), from the two CUDA events the port records around it, averaged
over the steps of the device-only pass (``core/program_spans``). None where
the port recorded no such span."""

from portbench.core.program_spans import phase_device_ms

PHASE = "train.forward"


def read(view):
    return phase_device_ms(view, PHASE)
