"""Share of its roofline that the RoI gather (kernel K6,
``deform_sample_kernel``) reaches in a served two-stage batch: the least
time of the gather the model asks for (each level's map read once, the
pooled output written) at the cell's shapes (kgbench/roofline_rcnn.py)
over the device time per batch of every K6 launch in the traced
stretch."""
from kgbench import roofline_rcnn

KERNELS = ('deform_sample_kernel',)


def read(obs):
    tl = obs.get('timeline')
    if tl is None:
        return None
    device = sum(s for name, s in tl['kernels_s'].items()
                 if any(k in name for k in KERNELS)) / tl['calls']
    if device <= 0:
        return None
    return 100.0 * roofline_rcnn.k6_least_seconds(
        obs['model'], obs['batch'], obs['canvases']) / device
