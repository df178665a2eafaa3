"""Training metrics: meters, the progress line and the JSONL writer (the
counterparts of moco_tpu/utils/metrics.py).

`AverageMeter` / `ProgressMeter` print the reference's
`Epoch: [e][i/n] Time ... Loss ... Acc@1 ...` lines (`main_moco.py:~L322-360`);
`MetricWriter` is the metrics.jsonl sink (obs/sinks.py). Console lines come
from rank 0 only when torch.distributed is initialized, as the reference
silences the other ranks (`main_moco.py:~L145`).
"""

from __future__ import annotations

import torch.distributed as dist

from moco_tpu_torch.obs.sinks import JsonlSink


def is_primary() -> bool:
    """True on the process that owns console output: rank 0, or any
    process when torch.distributed is not initialized."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def print0(*args, **kwargs) -> None:
    """`print` on the primary process only."""
    if is_primary():
        print(*args, **kwargs)


class AverageMeter:
    """Running value and average, formatted like the reference's meter."""

    def __init__(self, name: str, fmt: str = ":f"):
        self.name, self.fmt = name, fmt
        self.reset()

    def reset(self) -> None:
        self.val = self.sum = self.count = 0.0

    def update(self, val: float, n: int = 1) -> None:
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)

    def __str__(self) -> str:
        return ("{name} {val" + self.fmt + "} ({avg" + self.fmt + "})").format(
            name=self.name, val=self.val, avg=self.avg)


class ProgressMeter:
    """`Epoch: [e][ i/n] <meters>` lines; `display` prints on the primary
    process and always returns the line."""

    def __init__(self, num_batches: int, meters: list, prefix: str = ""):
        num_digits = len(str(num_batches))
        self.batch_fmtstr = "[{:" + str(num_digits) + "d}/" + str(num_batches) + "]"
        self.meters = meters
        self.prefix = prefix

    def display(self, batch: int) -> str:
        entries = [self.prefix + self.batch_fmtstr.format(batch)]
        entries += [str(m) for m in self.meters]
        line = "\t".join(entries)
        print0(line, flush=True)
        return line


class MetricWriter(JsonlSink):
    """The JSONL sink under the name the driver and the probe use."""
