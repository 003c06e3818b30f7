"""Host milliseconds of the program's ``mask_head`` span a served batch,
the median over the stretch that runs with the program's spans and no
profiler (kgbench/program_trace.py); none on a program without the
span. The span does not synchronize, so this is the host's time to
launch HTC's three mask heads, not their device time."""


def read(obs):
    pt = obs.get('program_trace')
    s = None if pt is None else pt['alone']['spans'].get('mask_head')
    return None if s is None else s['median_ms']
