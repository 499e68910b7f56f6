"""``attention_ms.*``: device milliseconds a unit of the fused attention
kernels, forward and backward, from the profiled window: every device
operation whose name holds one of :data:`KERNELS` (PyTorch's flash,
memory-efficient and cuDNN backends of ``scaled_dot_product_attention``),
clipped to the window, over its units. Picked by name and not by span,
so the reading holds inside a CUDA graph, whose kernels no launch call
ties to a span. None where the window ran no such kernel."""

# lower-case parts of the backends' kernel names: FlashAttention-2's
# ``flash_fwd_*`` / ``flash_bwd_*`` (its backward's dO.O and dQ-convert
# kernels among them), the memory-efficient ``fmha_cutlass*``, and cuDNN's
# ``*_sdpa_*`` kernels with the backward's two helpers,
# ``cudnn::fusion::compute_dot_do_o_*`` and ``convert_dq_to_16bits``
KERNELS = ("flash_fwd", "flash_bwd", "fmha_cutlass", "sdpa",
           "compute_dot_do_o", "convert_dq_to_16bits")


def is_attention(name: str) -> bool:
    low = name.lower()
    return any(k in low for k in KERNELS)


def attention_s(t):
    """Device seconds of the attention kernels in trace ``t``'s window, or
    None where it has none."""
    lo, hi = t.window
    total, seen = 0.0, False
    for s, d, name, _ in t.device_ops:
        if is_attention(name) and s + d > lo and s < hi:
            total += min(s + d, hi) - max(s, lo)
            seen = True
    return total if seen else None


def read(run):
    t = run.trace()
    s = attention_s(t)
    return None if s is None or not t.units else s / t.units * 1e3
