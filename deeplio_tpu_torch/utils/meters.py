"""Running statistics meters (counterpart of ``deeplio_tpu/utils/meters.py``;
reference: ``AverageMeter`` in ``deeplio/common/utils.py``)."""

from __future__ import annotations


class AverageMeter:
    """Tracks current value, running sum, count and average."""

    def __init__(self, name: str = "", fmt: str = ":.4f"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val: float, n: int = 1) -> None:
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)

    def __str__(self) -> str:
        return ("{name} {val" + self.fmt + "} (avg {avg" + self.fmt + "})"
                ).format(name=self.name, val=self.val, avg=self.avg)
