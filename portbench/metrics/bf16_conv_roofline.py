"""The trunk's bf16 convolutions (cuDNN, forward, input and weight
gradients): the least time their FLOPs need at the card's dense bf16
peak, over the device time of the bf16 kernels launched under a
convolution op, in %. The heads' float32 convolutions are left out of
both."""

from portbench.metrics import _bf16

MERGE = "mean"


def _bf16_kernel(name: str) -> bool:
    low = name.lower()
    return "bf16" in low or "bfloat16" in low


def read(run):
    if run.trace is None:
        return None
    conv = run.trace.under("convolution")
    t = run.trace.sum_s(lambda name, kind, link: conv(name, kind, link)
                        and _bf16_kernel(name))
    if not t:
        return None
    flops = run.work["steps"] * _bf16.step_flops(
        run.model, run.work["rank_batch"])["bf16"]
    return 100.0 * flops / _bf16.FLOPS_BF16 / t
