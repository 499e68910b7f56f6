"""``attention_roofline.*``: the fused attention's share of the chip's
bfloat16 peak, in %: the loop's attention FLOPs a unit
(``loops/train_rangevit.py::attention_flops``: ``12 T^2 D`` a block and
image in training) over the attention kernels' device seconds a unit
(``attention_ms``) and 989 TFLOP/s (``counts.PEAK_BF16_FLOPS``). None
where the loop counts no attention or the window ran no attention
kernel."""

from portbench.counts import PEAK_BF16_FLOPS
from portbench.metrics.attention_ms import attention_s


def read(run):
    flops = getattr(run.loop, "attention_flops_per_unit", None)
    t = run.trace()
    s = attention_s(t)
    if not flops or s is None or not t.units:
        return None
    return flops / (s / t.units) / PEAK_BF16_FLOPS * 100.0
