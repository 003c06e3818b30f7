"""Host milliseconds a served batch spends in the decode, the stage that
runs the greedy NMS loop: the benchmark's span from the end of the head's
call to the end of the predict call, both synchronized, averaged over the
traced stretch."""


def read(obs):
    ms = obs.get('stage_ms', {}).get('decode')
    return sum(ms) / len(ms) if ms else None
