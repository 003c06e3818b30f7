"""Model FLOP utilization of training: the operations of the images
stepped in the window (the reference's forward and backward, counted by
FlopCounterMode), over the window's seconds and the card's bfloat16 peak
(989 TFLOP/s)."""
from kgbench import roofline


def read(obs):
    if 'flops_per_image' not in obs:
        return None
    rate = obs['images'] * obs['flops_per_image'] / obs['seconds']
    return 100.0 * rate / roofline.PEAK_BF16_FLOPS
