"""The VGG-19 stack's share of its roofline in the profiled stretch of
style steps: the convolutions' counted operations of every profiled call,
forward and input gradient (counts_vgg.stack_flops, the driver's
`vgg_flops`), at the float32 rate, over the device time of the operations
between the marker kernels fenced around the stack's forward and around
its backward."""

from nerfbench import counts


def read(rec):
    if not rec or not rec["profile"]:
        return None
    dev = rec["profile"]["span_device_us"]
    dev_us = dev.get("vgg", []) + dev.get("vgg_backward", [])
    flops = rec["inputs"].get("vgg_flops", [])
    if not dev_us or sum(dev_us) <= 0 or len(flops) != len(dev_us):
        return None
    return 100.0 * sum(flops) / counts.F32_OPS_PER_S / (sum(dev_us) * 1e-6)
