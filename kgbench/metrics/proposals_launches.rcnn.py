"""Device operations (kernels, copies, memsets) launched inside the
program's ``proposals`` span (top-k per level, decode, clamp and the NMS),
per served batch of the profiled stretch (kgbench/program_trace.py); none
on a program without the span."""


def read(obs):
    pt = obs.get('program_trace')
    s = None if pt is None else pt['profiled']['spans'].get('proposals')
    return None if s is None else s['launches'] / s['calls']
