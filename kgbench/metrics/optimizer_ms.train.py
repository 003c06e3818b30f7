"""Host milliseconds of a training step's optimizer update
(``SGDOptimizer.step``), synchronized at both ends, averaged over the
traced steps."""


def read(obs):
    ms = obs.get('stage_ms', {}).get('optimizer')
    return sum(ms) / len(ms) if ms else None
