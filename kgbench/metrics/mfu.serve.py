"""Model FLOP utilization of offline serving: the operations of the images
completed in the window, counted over the benchmark's reference forward,
over the window's seconds and the card's bfloat16 peak (989 TFLOP/s)."""
from kgbench import roofline


def read(obs):
    if 'flops_per_image' not in obs:
        return None
    rate = obs['images'] * obs['flops_per_image'] / obs['seconds']
    return 100.0 * rate / roofline.PEAK_BF16_FLOPS
