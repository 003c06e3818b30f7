"""Device milliseconds a training step of the NCCL kernels launched inside
the program's ``allreduce`` span (the gradients' sum over the processes,
``parallel/dist.py::all_reduce_grads``), on process 0, from its profiled
stretch (kgbench/drivers/train_ddp.py); none on a program without the
span."""


def read(obs):
    a = obs.get('allreduce')
    if a is None or not a['calls'] or a['device_s'] <= 0:
        return None
    return 1e3 * a['device_s'] / a['calls']
