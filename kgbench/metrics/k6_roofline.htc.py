"""Share of its roofline that the RoI gather (kernel K6,
``deform_sample_kernel``) reaches in a served HTC batch: the least time of
the eight gathers the model asks for (each one's maps read once, its
pooled output written) at the cell's shapes (kgbench/roofline_htc.py) over
the device time per batch of every K6 launch in the traced stretch."""
from kgbench import roofline_htc

KERNELS = ('deform_sample_kernel',)


def read(obs):
    tl = obs.get('timeline')
    if tl is None:
        return None
    device = sum(s for name, s in tl['kernels_s'].items()
                 if any(k in name for k in KERNELS)) / tl['calls']
    if device <= 0:
        return None
    return 100.0 * roofline_htc.k6_least_seconds(
        obs['model'], obs['batch'], obs['canvases']) / device
