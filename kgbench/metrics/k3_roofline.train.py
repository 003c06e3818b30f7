"""Share of its roofline that the deformable sampling's backward (kernel
K3, ``deform_bwd*`` kernels) reaches in a training step: the least time of
the step's K3 calls at the cell's shapes (kgbench/roofline.py) over their
device time per step in the traced stretch."""
from kgbench import roofline

KERNELS = ('deform_bwd',)


def read(obs):
    tl = obs.get('timeline')
    if tl is None:
        return None
    device = sum(s for name, s in tl['kernels_s'].items()
                 if any(k in name for k in KERNELS)) / tl['calls']
    if device <= 0:
        return None
    least = roofline.least_seconds_of(roofline.k3_calls(
        obs['model'], obs['batch'], obs['canvases'][0]))
    return 100.0 * least / device
