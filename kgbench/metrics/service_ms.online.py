"""Median milliseconds from the start of a request's service to its result
on the host: ``Detector.__call__`` with its host preprocessing, batch-1
predict and host filter."""
import statistics


def read(obs):
    service = obs.get('service_s')
    return 1e3 * statistics.median(service) if service else None
