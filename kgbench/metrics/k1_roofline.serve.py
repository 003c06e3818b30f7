"""Share of its roofline that the head's fused deformable gather and
contraction (kernel K1, ``deform_fused*`` kernels) reaches in a served
batch: the least time of the batch's K1 calls at the cell's shapes
(kgbench/roofline.py) over their device time per batch in the traced
stretch."""
from kgbench import roofline

KERNELS = ('deform_fused',)


def read(obs):
    tl = obs.get('timeline')
    if tl is None:
        return None
    device = sum(s for name, s in tl['kernels_s'].items()
                 if any(k in name for k in KERNELS)) / tl['calls']
    if device <= 0:
        return None
    least = roofline.least_seconds_of(roofline.k1_calls(
        obs['model'], obs['batch'], obs['canvases'][0]))
    return 100.0 * least / device
