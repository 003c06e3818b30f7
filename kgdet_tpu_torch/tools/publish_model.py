"""Publish a checkpoint of the port: drop the optimizer state, tag the
weights with a content hash.

Parity surface: reference tools/publish_model.py:16-25 (drop the optimizer,
append a sha256 prefix to the name) and kgdet_tpu/tools/publish_model.py.
The tag is the first 8 hex digits of a sha256 over the state_dict's names,
in sorted order, each followed by its tensor's bytes; it is the port's own
and differs from the JAX tool's. ``init_detector(cfg, path)`` and
``tools/test.py --checkpoint`` load the result.

Usage:
  python -m kgdet_tpu_torch.tools.publish_model \
      work_dirs/x/checkpoints/1000 out_dir
"""
from __future__ import annotations

import argparse
import hashlib
import os

import torch


def content_tag(state_dict) -> str:
    h = hashlib.sha256()
    for name in sorted(state_dict):
        h.update(name.encode())
        t = state_dict[name].detach().cpu().contiguous().reshape(-1)
        h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:8]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('checkpoint', help='train-state checkpoint of the port')
    p.add_argument('out_dir')
    args = p.parse_args(argv)

    from kgdet_tpu_torch.utils.checkpoint import load_params, save_params

    state_dict = load_params(args.checkpoint)
    tag = content_tag(state_dict)
    out = os.path.join(args.out_dir, f'kgdet_model-{tag}')
    save_params(out, state_dict)
    print(f'published {out} (sha256 {tag})')
    return out


if __name__ == '__main__':
    main()
