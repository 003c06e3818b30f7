"""Weights into the port: flax variables -> a state_dict under the
reference's torch names, and the loader of a reference .pth.

The inverse of kgdet_tpu/utils/torch_convert.py for the ported modules
(backbone, neck, the KGDet cascade heads and the serial / parallel / plain
RepPoints heads): its layout maps are inverted, not re-derived.
  _conv_kernel  (Cout,Cin,kh,kw) -> (kh,kw,Cin,Cout)   inverse: (3,2,0,1)
  _dense_kernel (Cout,Cin,1,1)   -> (Cin,Cout)     inverse: .T[..., None, None]
  _dcn_kernel   (Cout,Cin,k,k)   -> tap-major (k*k,Cin,Cout)
                                                  inverse: (2,1,0) + reshape
FrozenBatchNorm scale/bias and batch_stats mean/var map to
weight/bias/running_mean/running_var (plus num_batches_tracked = 0, which
reference checkpoints carry); GroupNorm scale/bias to weight/bias.

The port's modules use these names, so ``load_state_dict(strict=True)``
takes the result, and also takes a reference .pth directly.
"""
from __future__ import annotations

import re
from collections import OrderedDict
from typing import Any, Dict, Tuple

import numpy as np
import torch


def _inv_conv(w):
    return np.transpose(w, (3, 2, 0, 1))


def _inv_dense(w):
    return np.transpose(w, (1, 0))[:, :, None, None]


def _inv_dcn(w):
    taps, cin, cout = w.shape
    k = int(round(taps ** 0.5))
    return np.transpose(w, (2, 1, 0)).reshape(cout, cin, k, k)


_NORM_LEAF = {'scale': 'weight', 'bias': 'bias', 'mean': 'running_mean',
              'var': 'running_var'}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, 'items'):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, dtype=np.float32)


def _backbone_name(path: Tuple[str, ...]) -> Tuple[str, Any]:
    """('conv1', 'kernel') / ('layer1/0', 'downsample_bn', 'scale') / ...
    -> (torch name, layout inverse)."""
    *mods, leaf = path
    mods = [m.replace('/', '.') for m in mods]
    mods = ['downsample.0' if m == 'downsample_conv' else
            'downsample.1' if m == 'downsample_bn' else m for m in mods]
    if leaf == 'kernel':
        return 'backbone.' + '.'.join(mods) + '.weight', _inv_conv
    return 'backbone.' + '.'.join(mods) + '.' + _NORM_LEAF[leaf], None


def _neck_name(path):
    mod, sub, leaf = path
    m = re.match(r'(lateral|fpn)_(\d+)$', mod)
    if not m:
        raise KeyError(f'neck/{"/".join(path)}')
    base = f'neck.{m.group(1)}_convs.{m.group(2)}.{sub}'
    if sub == 'conv':
        return (base + ('.weight' if leaf == 'kernel' else '.bias'),
                _inv_conv if leaf == 'kernel' else None)
    return base + '.' + _NORM_LEAF[leaf], None


def _head_name(path):
    if path == ('moment_transfer',):
        return 'bbox_head.moment_transfer', None
    m = re.match(r'(cls|reg)_convs_(\d+)$', path[0])
    if m:
        _, sub, leaf = path
        base = f'bbox_head.{m.group(1)}_convs.{m.group(2)}.{sub}'
        if sub == 'conv':
            return (base + ('.weight' if leaf == 'kernel' else '.bias'),
                    _inv_conv if leaf == 'kernel' else None)
        return base + '.' + _NORM_LEAF[leaf], None
    # serial / parallel / plain RepPoints heads
    if re.match(r'(cls|keypts|reppts)_refine_dfmconv$', path[0]):
        return f'bbox_head.{path[0]}.weight', _inv_dcn
    if re.match(r'(keypts|reppts)_init_conv$|'
                r'(cls|keypts|reppts)_(init|refine)_out$', path[0]):
        base = f'bbox_head.{path[0]}'
        if path[1] == 'bias':
            return base + '.bias', None
        return base + '.weight', (_inv_conv if path[0].endswith('_conv')
                                  else _inv_dense)
    if re.match(r'kp_rep_block_\d$', path[0]):
        base = f'bbox_head.{path[0]}.{path[1]}'
        if re.match(r'(cls|keypts)_dfmconv(_\d)?$', path[1]):
            return base + '.weight', _inv_dcn
        leaf = path[2]
        if leaf == 'bias':
            return base + '.bias', None
        if path[1] in ('cls_conv', 'keypts_conv'):
            return base + '.weight', _inv_conv
        return base + '.weight', _inv_dense
    raise KeyError(f'head/{"/".join(path)}')


def state_dict_from_jax(variables: Dict) -> 'OrderedDict[str, torch.Tensor]':
    """flax {'params', 'batch_stats'} of a KGDetDetector -> torch
    state_dict under the reference names (f32 tensors)."""
    state = OrderedDict()
    trees = [variables['params']]
    if variables.get('batch_stats'):
        trees.append(variables['batch_stats'])
    for tree in trees:
        for path, v in _flatten(tree):
            comp, rest = path[0], path[1:]
            if comp == 'backbone':
                name, inv = _backbone_name(rest)
            elif comp == 'neck':
                name, inv = _neck_name(rest)
            elif comp == 'head':
                name, inv = _head_name(rest)
            else:
                raise KeyError('/'.join(path))
            state[name] = torch.from_numpy(
                np.array(inv(v) if inv else v, dtype=np.float32))
            if name.endswith('.running_mean'):
                state[name[:-len('running_mean')] + 'num_batches_tracked'] = \
                    torch.tensor(0, dtype=torch.long)
    return state


def load_pth(path: str) -> Dict[str, torch.Tensor]:
    """The model state_dict of an mmcv-style reference .pth, on the CPU:
    unwraps a ``state_dict`` nesting and strips DataParallel's ``module.``
    prefix (what kgdet_tpu/utils/torch_convert.py::load_pth does). The
    port's modules carry the reference names, so ``load_state_dict`` takes
    the result as it is. The file is unpickled: load only files you
    trust."""
    ckpt = torch.load(path, map_location='cpu', weights_only=False)
    state = ckpt.get('state_dict', ckpt)
    return {k[len('module.'):] if k.startswith('module.') else k: v
            for k, v in state.items()}
