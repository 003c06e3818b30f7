"""Device operations (kernels, copies, memsets) launched inside the
program's ``mask_head`` span (HTC's three mask heads: their convs, the
transposed convs, the information flow), per served batch of the profiled
stretch (kgbench/program_trace.py); none on a program without the span."""


def read(obs):
    pt = obs.get('program_trace')
    s = None if pt is None else pt['profiled']['spans'].get('mask_head')
    return None if s is None else s['launches'] / s['calls']
