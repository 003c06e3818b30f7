"""Weights into the port: flax variables -> a state_dict under the
reference's torch names, and the loader of a reference .pth.

The inverse of kgdet_tpu/utils/torch_convert.py for the ported modules
(the ResNet / ResNeXt backbones with their DCN blocks and plugins, HRNet,
the SSDVGG trunk; the FPN, HRFPN, BFP and FPNBFP necks; the KGDet cascade
heads, the serial / parallel / plain RepPoints heads, RetinaHead, SSDHead,
FCOSHead and GARetinaHead; the two-stage detectors' rpn_head (GA-RPN's
too), ConvFC, double and average-pool box heads, the cascade's
bbox_head.<stage>, the C4 shared_head, mask_head (HTC's mask_head.<stage>),
mask_iou_head, semantic_head and grid_head): its layout maps are inverted,
not re-derived. FCOS's flax ``scales`` vector becomes one
``scales.<level>.scale`` scalar a level (the inverse of its ``_scales_tmp``
pass). The mask head's ``conv_logits`` gains the reference's background
channel 0 as zeros (the JAX converter drops it); the grid head's per-point
flax deconvs are stacked into the reference's grouped deconv1 / deconv2.
  _conv_kernel  (Cout,Cin,kh,kw) -> (kh,kw,Cin,Cout)   inverse: (3,2,0,1)
  _dense_kernel (Cout,Cin,1,1)   -> (Cin,Cout)     inverse: .T[..., None, None]
  _dcn_kernel   (Cout,Cin,k,k)   -> tap-major (k*k,Cin,Cout)
                                                  inverse: (2,1,0) + reshape
  _fc_kernel    (Cout,Cin)       -> (Cin,Cout)     inverse: .T
  _roi_flat_fc_kernel (Cout, C*r*r), inputs (C, r, r) -> (r*r*C, Cout),
                inputs (r, r, C)     inverse: reshape, (3,2,0,1), reshape
  _deconv_kernel (Cin,Cout,kh,kw) -> (kh,kw,Cin,Cout), spatially flipped
                                  inverse: flip, (2,3,0,1)
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


def _inv_fc(w):
    return np.transpose(w, (1, 0))


def _inv_roi_flat_fc(w, roi=7):
    in_f, out_f = w.shape
    c = in_f // (roi * roi)
    return np.transpose(w.reshape(roi, roi, c, out_f),
                        (3, 2, 0, 1)).reshape(out_f, in_f)


def _inv_deconv(w):
    return np.ascontiguousarray(np.transpose(w[::-1, ::-1], (2, 3, 0, 1)))


def _inv_logits(w):
    """The mask head's foreground conv_logits with a zero background
    channel 0 in front (kernel or bias)."""
    w = _inv_conv(w) if w.ndim == 4 else w
    return np.concatenate([np.zeros_like(w[:1]), w], 0)


def _inv_ln(w):                 # the context block's LayerNorm([C, 1, 1])
    return w[:, None, None]


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


_PLUGIN_DENSE = ('query_conv', 'key_conv', 'value_conv', 'proj_conv')


def _plugin_name(base, mods, leaf):
    """A block plugin's leaf (models/plugins.py names) under ``base``."""
    plugin, sub = mods[0], mods[1:]
    base = f'{base}.{plugin}'
    if plugin == 'gen_attention_block':
        if not sub:                 # appr_bias / geom_bias / gamma
            return f'{base}.{leaf}', None
        if sub[0] in _PLUGIN_DENSE:
            return (f'{base}.{sub[0]}.weight', _inv_dense) \
                if leaf == 'kernel' else (f'{base}.{sub[0]}.bias', None)
        return f'{base}.{sub[0]}.weight', _inv_fc   # appr_geom_fc_x / _y
    if plugin == 'context_block':
        m = re.match(r'(channel_add|channel_mul)_(conv1|ln|conv2)$', sub[0])
        if m:
            seq = {'conv1': 0, 'ln': 1, 'conv2': 3}[m.group(2)]
            base = f'{base}.{m.group(1)}_conv.{seq}'
            if m.group(2) == 'ln':
                return (f'{base}.weight', _inv_ln) if leaf == 'scale' \
                    else (f'{base}.bias', _inv_ln)
        else:                       # conv_mask
            base = f'{base}.{sub[0]}'
        return (f'{base}.weight', _inv_conv) if leaf == 'kernel' \
            else (f'{base}.bias', None)
    return _conv_module_name(f'{base}.{sub[0]}', leaf)   # nonlocal_block


def _conv_module_name(base, leaf):
    """A flax Conv with a bias held as the reference's ConvModule."""
    return (f'{base}.conv.weight', _inv_conv) if leaf == 'kernel' \
        else (f'{base}.conv.bias', None)


def _hrnet_prefix(mod):
    """HRNet's literal flax names: 'transition1/0/0' (a channel-fix conv,
    the reference's Sequential transition1.0) or 'transition1/1/0' (the
    first conv of a new branch's chain, transition1.1.0); fuse layers and
    branch blocks map '/' to '.'."""
    parts = mod.split('/')
    m = re.match(r'transition(\d+)$', parts[0])
    if m and int(parts[1]) < int(m.group(1)):   # an existing branch
        parts = parts[:2]
    return '.'.join(parts)


def _backbone_name(path: Tuple[str, ...]) -> Tuple[str, Any]:
    """('conv1', 'kernel') / ('layer1/0', 'downsample_bn', 'scale') /
    ('layer2/0', 'conv2', 'conv_offset', 'kernel') / ('features_0',
    'kernel') / ('transition1/0/0/conv', 'kernel') / ... -> (torch name,
    layout inverse)."""
    *mods, leaf = path
    m = re.match(r'(features|extra)_(\d+)$', mods[0])
    if m:                           # SSDVGG trunk (torch_convert.py:159-162)
        base = f'backbone.{m.group(1)}.{m.group(2)}'
        return (base + '.weight', _inv_conv) if leaf == 'kernel' \
            else (base + '.bias', None)
    if mods == ['l2_norm']:
        return 'backbone.l2_norm.weight', None
    m = re.match(r'(.*)/(conv|bn)$', mods[0])
    if m and re.match(r'(transition|stage)\d', mods[0]):
        # HRNet's Sequential(conv, bn): children 0 and 1
        base = f'backbone.{_hrnet_prefix(m.group(1))}'
        if m.group(2) == 'conv':
            return base + '.0.weight', _inv_conv
        return f'{base}.1.{_NORM_LEAF[leaf]}', None
    if len(mods) > 1 and mods[1] in ('gen_attention_block', 'context_block',
                                     'nonlocal_block'):
        return _plugin_name('backbone.' + mods[0].replace('/', '.'),
                            mods[1:], leaf)
    mods = [mod.replace('/', '.') for mod in mods]
    if mods[-1] == 'conv_offset':   # a DCN block's offset conv, conv2's
        base = 'backbone.' + '.'.join(mods[:-2]) + '.conv2_offset'
        return (base + '.weight', _inv_conv) if leaf == 'kernel' \
            else (base + '.bias', None)
    if leaf == 'weight':            # a DCN block's tap-major conv2 weight
        return 'backbone.' + '.'.join(mods) + '.weight', _inv_dcn
    mods = ['downsample.0' if m == 'downsample_conv' else
            'downsample.1' if m == 'downsample_bn' else m for m in mods]
    if leaf == 'kernel':
        return 'backbone.' + '.'.join(mods) + '.weight', _inv_conv
    return 'backbone.' + '.'.join(mods) + '.' + _NORM_LEAF[leaf], None


def _neck_name(path, base='neck'):
    if path[0] in ('fpn', 'bfp'):   # FPNBFP: the reference's neck list
        return _neck_name(path[1:],
                          f'{base}.{0 if path[0] == "fpn" else 1}')
    if path[0] == 'reduction_conv':                 # HRFPN
        return _conv_module_name(f'{base}.reduction_conv', path[-1])
    m = re.match(r'fpn_convs_(\d+)$', path[0])
    if m:                                           # HRFPN
        return _conv_module_name(f'{base}.fpn_convs.{m.group(1)}', path[-1])
    if path[0] == 'refine':                         # BFP
        if len(path) == 3:                          # the non-local refine
            return _conv_module_name(f'{base}.refine.{path[1]}', path[2])
        return _conv_module_name(f'{base}.refine', path[1])
    mod, sub, leaf = path
    m = re.match(r'(lateral|fpn)_(\d+)$', mod)
    if not m:
        raise KeyError(f'neck/{"/".join(path)}')
    base = f'{base}.{m.group(1)}_convs.{m.group(2)}.{sub}'
    if sub == 'conv':
        return (base + ('.weight' if leaf == 'kernel' else '.bias'),
                _inv_conv if leaf == 'kernel' else None)
    return base + '.' + _NORM_LEAF[leaf], None


def _head_name(path):
    if path == ('moment_transfer',):
        return 'bbox_head.moment_transfer', None
    if path[0] in ('retina_cls', 'retina_reg', 'fcos_cls', 'fcos_reg',
                   'fcos_centerness', 'conv_loc', 'conv_shape'):
        return (f'bbox_head.{path[0]}.weight', _inv_conv) \
            if path[1] == 'kernel' else (f'bbox_head.{path[0]}.bias', None)
    if path[0] in ('feature_adaption_cls', 'feature_adaption_reg'):
        base = f'bbox_head.{path[0]}.{path[1]}.weight'
        return (base, _inv_conv) if path[1] == 'conv_offset' \
            else (base, _inv_dcn)
    m = re.match(r'(cls|reg)_convs_(\d+)$', path[0])
    if m and len(path) == 2:        # SSDHead's plain per-level convs
        base = f'bbox_head.{m.group(1)}_convs.{m.group(2)}'
        return (base + '.weight', _inv_conv) if path[1] == 'kernel' \
            else (base + '.bias', None)
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


def _box_head_name(base, path):
    """A two-stage box head's leaf under ``base`` (bbox_head, or
    bbox_head.<stage> of the cascade): ConvFC, the double head, the
    average-pool head."""
    mod, leaf = path[0], path[-1]
    m = re.match(r'(shared_fc|fc_branch|conv_branch)_(\d+)$', mod)
    if m and m.group(1) == 'conv_branch':
        sub = f'{base}.conv_branch.{m.group(2)}.{path[1]}'
        return (sub + '.weight', _inv_conv) if leaf == 'kernel' \
            else (sub + '.' + _NORM_LEAF[leaf], None)
    if m:
        name = f'{base}.{m.group(1).replace("shared_fc", "shared_fcs")}' \
            f'.{m.group(2)}'
        if leaf == 'bias':
            return name + '.bias', None
        return name + '.weight', \
            _inv_roi_flat_fc if m.group(2) == '0' else _inv_fc
    if mod in ('fc_cls', 'fc_reg'):
        return (f'{base}.{mod}.weight', _inv_fc) if leaf == 'kernel' \
            else (f'{base}.{mod}.bias', None)
    if mod == 'res_block':          # ConvModules: conv<i>.conv, conv<i>.gn
        sub = path[1]
        if sub.startswith('gn'):
            return (f'{base}.res_block.{sub.replace("gn", "conv")}.gn.'
                    f'{_NORM_LEAF[leaf]}', None)
        return (f'{base}.res_block.{sub}.conv.weight', _inv_conv) \
            if leaf == 'kernel' else (f'{base}.res_block.{sub}.conv.bias',
                                      None)
    raise KeyError(f'{base}/{"/".join(path)}')


def _conv_name(base, leaf, inv=_inv_conv):
    """A plain conv's kernel or bias under ``base``."""
    return (f'{base}.weight', inv) if leaf == 'kernel' \
        else (f'{base}.bias', None)


def _mask_head_name(base, path):
    mod, leaf = path[0], path[-1]
    m = re.match(r'conv_(\d+)$', mod)
    if m:
        return _conv_name(f'{base}.convs.{m.group(1)}.conv', leaf)
    if mod == 'conv_res':
        return _conv_name(f'{base}.conv_res.conv', leaf)
    if mod == 'upsample':
        return _conv_name(f'{base}.upsample', leaf, _inv_deconv)
    if mod == 'conv_logits':
        name, _ = _conv_name(f'{base}.conv_logits', leaf)
        return name, _inv_logits
    raise KeyError(f'{base}/{"/".join(path)}')


def _maskiou_head_name(path):
    mod, leaf = path[0], path[-1]
    m = re.match(r'(conv|fc)_(\d+)$', mod)
    if m and m.group(1) == 'conv':
        return _conv_name(f'mask_iou_head.convs.{m.group(2)}', leaf)
    if m:
        inv = _inv_roi_flat_fc if m.group(2) == '0' else _inv_fc
        return _conv_name(f'mask_iou_head.fcs.{m.group(2)}', leaf, inv)
    if mod == 'fc_mask_iou':
        return _conv_name('mask_iou_head.fc_mask_iou', leaf, _inv_fc)
    raise KeyError(f'mask_iou_head/{"/".join(path)}')


def _semantic_head_name(path):
    mod, leaf = path[0], path[-1]
    m = re.match(r'(lateral_convs|convs)_(\d+)$', mod)
    if m:
        return _conv_name(f'semantic_head.{m.group(1)}.{m.group(2)}.conv',
                          leaf)
    if mod == 'conv_embedding':
        return _conv_name('semantic_head.conv_embedding.conv', leaf)
    if mod == 'conv_logits':
        return _conv_name('semantic_head.conv_logits', leaf)
    raise KeyError(f'semantic_head/{"/".join(path)}')


def _grid_head_name(path):
    """The grid head's leaves but its per-point deconvs (``_grid_deconvs``
    stacks those)."""
    mod, leaf = path[0], path[-1]
    m = re.match(r'convs_(gn_)?(\d+)$', mod)
    if m and m.group(1):
        return f'grid_head.convs.{m.group(2)}.gn.{_NORM_LEAF[leaf]}', None
    if m:
        return _conv_name(f'grid_head.convs.{m.group(2)}.conv', leaf)
    m = re.match(r'(forder|sorder)_(\d+)_(\d+)$', mod)
    if m:
        seq = 0 if path[1] == 'dw' else 1
        return _conv_name(f'grid_head.{m.group(1)}_trans.{m.group(2)}.'
                          f'{m.group(3)}.{seq}', leaf)
    if mod == 'deconv1_gn':
        return f'grid_head.norm1.{_NORM_LEAF[leaf]}', None
    raise KeyError(f'grid_head/{"/".join(path)}')


def _grid_deconvs(tree):
    """The flax per-point deconv1_<i> / deconv2_<i> of a grid head stacked
    as the reference's grouped ConvTranspose2d weights and biases:
    deconv1 (P * c, c, 4, 4), deconv2 (P * c, 1, 4, 4) with bias (P,)."""
    out = {}
    for name in ('deconv1', 'deconv2'):
        pts = sorted((int(k.split('_')[1]), v) for k, v in tree.items()
                     if re.match(rf'{name}_\d+$', k))
        if not pts:
            continue
        out[f'grid_head.{name}.weight'] = np.concatenate(
            [_inv_deconv(np.asarray(v['kernel'], np.float32))
             for _, v in pts])
        out[f'grid_head.{name}.bias'] = np.concatenate(
            [np.asarray(v['bias'], np.float32) for _, v in pts])
    return out


def _two_stage_name(comp, path):
    """rpn_head (GA-RPN's too), bbox_head, bbox_head_<stage>, shared_head,
    mask_head, mask_head_<stage>, mask_iou_head, semantic_head and
    grid_head leaves."""
    if comp == 'rpn_head':
        if path[0] == 'feature_adaption':        # GA-RPN
            base = f'rpn_head.feature_adaption.{path[1]}.weight'
            return (base, _inv_conv) if path[1] == 'conv_offset' \
                else (base, _inv_dcn)
        return _conv_name(f'rpn_head.{path[0]}', path[1])
    m = re.match(r'mask_head(?:_(\d+))?$', comp)
    if m:
        return _mask_head_name('mask_head' if m.group(1) is None
                               else f'mask_head.{m.group(1)}', path)
    if comp == 'mask_iou_head':
        return _maskiou_head_name(path)
    if comp == 'semantic_head':
        return _semantic_head_name(path)
    if comp == 'grid_head':
        return _grid_head_name(path)
    if comp == 'shared_head':       # layer4.<i>, as the backbone's blocks
        name, inv = _backbone_name(path)
        return 'shared_head' + name[len('backbone'):], inv
    m = re.match(r'bbox_head(?:_(\d+))?$', comp)
    if not m:
        raise KeyError(f'{comp}/{"/".join(path)}')
    base = 'bbox_head' if m.group(1) is None else f'bbox_head.{m.group(1)}'
    return _box_head_name(base, path)


def state_dict_from_jax(variables: Dict) -> 'OrderedDict[str, torch.Tensor]':
    """flax {'params', 'batch_stats'} of a KGDetDetector or a two-stage
    detector -> torch state_dict under the reference names (f32
    tensors)."""
    state = OrderedDict()
    trees = [variables['params']]
    if variables.get('batch_stats'):
        trees.append(variables['batch_stats'])
    for tree in trees:
        for name, v in _grid_deconvs(tree.get('grid_head', {})).items():
            state[name] = torch.from_numpy(v)
        for path, v in _flatten(tree):
            comp, rest = path[0], path[1:]
            if comp == 'grid_head' and re.match(r'deconv[12]_\d+$',
                                                rest[0]):
                continue
            if (comp, rest) == ('head', ('scales',)):    # FCOS, a level each
                for i, scale in enumerate(v):
                    state[f'bbox_head.scales.{i}.scale'] = torch.tensor(
                        float(scale), dtype=torch.float32)
                continue
            if comp == 'backbone':
                name, inv = _backbone_name(rest)
            elif comp == 'neck':
                name, inv = _neck_name(rest)
            elif comp == 'head':
                name, inv = _head_name(rest)
            else:
                name, inv = _two_stage_name(comp, rest)
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


# ------------------------------------------------------ the converter's skips
# The JAX package's converter (kgdet_tpu/utils/torch_convert.py,
# convert_state_dict) maps a reference key onto its model or lists it as
# skipped. Its layout maps are not needed here (the port's modules carry the
# reference names), but which keys it skips is: a .pth loads into the port
# exactly as it loads there. The branches below are its 22 skip sites, in
# its order.
_GA_MODS = ('conv_loc', 'conv_shape', 'conv_cls', 'conv_reg', 'retina_cls',
            'retina_reg')


def _ga_maps(p):
    if p[0] in _GA_MODS:
        return True
    if p[0] in ('feature_adaption', 'feature_adaption_cls',
                'feature_adaption_reg'):
        return p[1] in ('conv_offset', 'conv_adaption') and p[2] == 'weight'
    return False


def _block_sub_maps(sub):
    return sub.startswith(('conv', 'bn')) or sub == 'downsample'


def _backbone_skips(p):
    if p[0] in ('features', 'extra', 'l2_norm') or \
            re.match(r'transition\d$', p[0]):
        return False
    if re.match(r'stage\d$', p[0]):
        if p[2] == 'branches':
            return not _block_sub_maps(p[5])
        return p[2] != 'fuse_layers'
    if p[0] in ('conv1', 'conv2', 'bn1', 'bn2'):
        return False
    if re.match(r'layer\d$', p[0]):
        sub = p[2]
        if sub == 'gen_attention_block':
            return p[3] not in (
                'query_conv', 'key_conv', 'value_conv', 'proj_conv',
                'appr_geom_fc_x', 'appr_geom_fc_y', 'appr_bias',
                'geom_bias', 'gamma')
        if sub == 'context_block':
            if p[3] == 'conv_mask':
                return False
            if p[3] in ('channel_add_conv', 'channel_mul_conv'):
                return p[4] not in ('0', '1', '3')
            return True
        return not (sub == 'conv2_offset' or _block_sub_maps(sub))
    return True


def _neck_skips(p, is_hrfpn):
    if p[0] in ('0', '1'):
        return _neck_skips(p[1:], is_hrfpn)
    if p[0] in ('reduction_conv', 'refine') or \
            (is_hrfpn and p[0] == 'fpn_convs'):
        return False
    if not re.match(r'(lateral|fpn)_convs$', p[0]):
        return True
    return p[2] not in ('conv', 'gn')


def _head_skips(p):
    convfc = ('shared_fcs', 'fc_cls', 'fc_reg')
    if p[0].isdigit():
        return p[1] not in convfc
    if p[0] in convfc + ('res_block', 'fc_branch', 'moment_transfer',
                         'keypts_init_conv', 'reppts_init_conv', 'fcos_cls',
                         'fcos_reg', 'fcos_centerness', 'scales') \
            or _ga_maps(p):
        return False
    if p[0] == 'conv_branch':
        return not p[2].startswith(('conv', 'gn'))
    if re.match(r'(cls|reg)_convs$', p[0]):
        return p[2] not in ('weight', 'bias', 'conv', 'gn')
    if re.match(r'(cls|keypts|reppts)_(init|refine)_(dfmconv|out)$', p[0]):
        return False
    if re.match(r'kp_rep_block_\d$', p[0]):
        return not (re.match(r'(cls|keypts)_dfmconv(_\d)?$', p[1]) or p[1] in
                    ('cls_out', 'keypts_out', 'reppts_out', 'cls_conv',
                     'keypts_conv'))
    return True


def converter_skips(key: str, is_hrfpn: bool = False) -> bool:
    """Whether the JAX package's converter lists reference key ``key`` as
    skipped (maps it onto no parameter). ``is_hrfpn``: the state_dict has
    an HRFPN neck (a ``neck.reduction_conv.`` key), whose ``fpn_convs``
    it maps however they are named."""
    top, *p = key.split('.')
    if top == 'backbone':
        return _backbone_skips(p)
    if top == 'neck':
        return _neck_skips(p, is_hrfpn)
    if top == 'bbox_head':
        return _head_skips(p)
    if top == 'rpn_head':
        return not (p[0] in ('rpn_conv', 'rpn_cls', 'rpn_reg')
                    or _ga_maps(p))
    if top == 'mask_head':
        p = p[1:] if p[0].isdigit() else p
        return p[0] not in ('convs', 'conv_res', 'upsample', 'conv_logits')
    if top == 'grid_head':
        return p[0] not in ('convs', 'forder_trans', 'sorder_trans',
                            'deconv1', 'norm1', 'deconv2')
    if top == 'shared_head':
        return not (re.match(r'layer\d$', p[0]) and _block_sub_maps(p[2]))
    if top == 'mask_iou_head':
        return p[0] not in ('convs', 'fcs', 'fc_mask_iou')
    if top == 'semantic_head':
        return p[0] not in ('lateral_convs', 'convs', 'conv_embedding',
                            'conv_logits')
    return True


def load_reference_state(model, state: Dict[str, torch.Tensor]):
    """Load a reference state_dict (``load_pth``) into ``model`` in place,
    accepting and refusing what the JAX package's ``.pth`` routes do
    (convert_state_dict, then merge_into_variables(strict=True)): keys its
    converter skips are dropped and returned; a key it maps that the model
    lacks raises KeyError; a shape that differs from the model's raises
    ValueError; model keys the state lacks keep their values. BatchNorm's
    ``num_batches_tracked``, which no layer reads, is not loaded. FCOS's
    per-level scales go in as the JAX converter assembles them (the levels
    present, in order, one vector: a count other than the model's raises
    ValueError). Nothing is loaded unless every key passes. Returns the
    skipped keys."""
    is_hrfpn = any(k.startswith('neck.reduction_conv.') for k in state)
    own = model.state_dict()
    state = _fcos_scales_in_order(state, own)
    skipped, take = [], {}
    for key, value in state.items():
        if converter_skips(key, is_hrfpn):
            skipped.append(key)
        elif key.endswith('.num_batches_tracked'):
            continue
        elif key not in own:
            raise KeyError(f'{key} is mapped by the converter but not a '
                           'key of the model')
        elif _plain_conv2_into_dcn(key, state, own):
            raise KeyError(
                f'{key}: without its block\'s conv2_offset the converter '
                'maps it as a plain conv, and the model\'s block is a DCN')
        elif tuple(value.shape) != tuple(own[key].shape):
            raise ValueError(f'{key}: shape {tuple(value.shape)} != the '
                             f"model's {tuple(own[key].shape)}")
        else:
            take[key] = value
    model.load_state_dict(take, strict=False)
    return skipped


_SCALE = re.compile(r'bbox_head\.scales\.(\d+)\.scale$')


def _fcos_scales_in_order(state, own):
    """The reference's ``scales.<level>.scale`` scalars renumbered as the
    JAX converter's ``_scales_tmp`` pass lays them out: the levels present,
    in ascending order, become levels 0, 1, ... of one vector, which must
    have the model's length. Only for a model with scales."""
    keys = sorted((k for k in state if _SCALE.match(k)),
                  key=lambda k: int(_SCALE.match(k).group(1)))
    n_own = sum(1 for k in own if _SCALE.match(k))
    if not keys or not n_own:
        return state
    if len(keys) != n_own:
        raise ValueError(f'bbox_head.scales: {len(keys)} levels != the '
                         f"model's {n_own}")
    out = {k: v for k, v in state.items() if not _SCALE.match(k)}
    for i, k in enumerate(keys):
        if state[k].numel() != 1:
            raise ValueError(f'{k}: shape {tuple(state[k].shape)} is not a '
                             'scalar')
        out[f'bbox_head.scales.{i}.scale'] = state[k].reshape(())
    return out


def _plain_conv2_into_dcn(key, state, own):
    """Whether ``key`` is a backbone block's conv2 weight that the JAX
    converter lays out as a plain conv kernel (its state has no
    conv2_offset for the block: torch_convert.py:96-107) while the model's
    block is a DCN (it has a conv2_offset): the JAX route refuses that
    merge."""
    m = re.match(r'(backbone\.layer\d+\.\d+)\.conv2\.weight$', key)
    return bool(m) and f'{m.group(1)}.conv2_offset.weight' in own \
        and f'{m.group(1)}.conv2_offset.weight' not in state \
        and f'{m.group(1)}.conv2_offset.bias' not in state
