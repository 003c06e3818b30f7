"""Mean milliseconds a request waited from its due time to the start of
its service, from the load generator's own timestamps."""


def read(obs):
    wait = obs.get('wait_s')
    return 1e3 * sum(wait) / len(wait) if wait else None
