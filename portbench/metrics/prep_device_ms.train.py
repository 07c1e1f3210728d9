"""prep_device_ms.train: the device time a training step of the port's span
``train.preprocess`` (``device_preprocess``: the uint8 image to float32 less
the means, the maps' bit unpacks and casts), from the two CUDA events the
port records around it, averaged over the steps of the device-only pass
(``core/program_spans``). None where the port recorded no such span."""

from portbench.core.program_spans import phase_device_ms

PHASE = "train.preprocess"


def read(view):
    return phase_device_ms(view, PHASE)
