"""Mean milliseconds a training step waited at ``next()`` on the Runner's
device-prefetch iterator for its batch (the loader's threads and the copy
to the card), over the window's steps."""


def read(obs):
    waits = obs.get('data_wait_s')
    return 1e3 * sum(waits) / len(waits) if waits else None
