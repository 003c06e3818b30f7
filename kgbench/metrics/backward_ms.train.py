"""Host milliseconds of a training step's backward (``Tensor.backward`` of
the loss), synchronized at both ends, averaged over the traced steps."""


def read(obs):
    ms = obs.get('stage_ms', {}).get('backward')
    return sum(ms) / len(ms) if ms else None
