"""Device ms a train step spends in the optimizer (`train.optimizer`:
clipping and AdamW), over the train steps of the traced stretch (where it
held none, the job's step after the close): the device time of every
operation launched inside the program's span (torch.profiler, joined by
correlation id)."""
from muxbench.metrics._spans import device_ms


def read(rd):
    return device_ms(rd, "train.optimizer")
