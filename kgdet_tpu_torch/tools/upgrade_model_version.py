"""Upgrade old-version torch checkpoints to the v1 names.

Port of kgdet_tpu/tools/upgrade_model_version.py (parity: reference
tools/upgrade_model_version.py): pre-v1 mmdet checkpoints name head convs
``cls_convs.0.weight``; v1 wraps them in ConvModule
(``cls_convs.0.conv.weight``). The output keeps the rest of the file and
loads through ``utils/convert.py::load_pth``. torch only:

  python -m kgdet_tpu_torch.tools.upgrade_model_version in.pth out.pth
"""
from __future__ import annotations

import argparse
import re


def upgrade_state_dict(state_dict):
    """Rename pre-v1 keys to the v1 layout. Returns (new_dict, n_renamed)."""
    out = {}
    renamed = 0
    for key, val in state_dict.items():
        m = re.search(r'(cls_convs|reg_convs)\.\d+\.(weight|bias)', key)
        if m is not None:
            param = m.group(2)
            key = key.replace(param, f'conv.{param}')
            renamed += 1
        out[key] = val
    return out, renamed


def main(argv=None):
    p = argparse.ArgumentParser(description='Upgrade model version')
    p.add_argument('in_file')
    p.add_argument('out_file')
    args = p.parse_args(argv)
    import torch
    # a reference checkpoint's meta is pickled: load only files you trust
    ckpt = torch.load(args.in_file, map_location='cpu', weights_only=False)
    state = ckpt.pop('state_dict', None)
    if state is None:
        state, ckpt = ckpt, {}
    new_state, n = upgrade_state_dict(state)
    ckpt['state_dict'] = new_state
    torch.save(ckpt, args.out_file)
    print(f'[upgrade] renamed {n} keys -> {args.out_file}')
    return n


if __name__ == '__main__':
    main()
