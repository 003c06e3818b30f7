"""Share of the traced stretch's wall time in which no kernel, copy or
memset ran on the device."""


def read(obs):
    tl = obs.get('timeline')
    if tl is None or tl['window_s'] <= 0:
        return None
    return 100.0 * (1.0 - tl['busy_s'] / tl['window_s'])
