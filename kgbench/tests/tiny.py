"""The cells of the benchmark shrunk for the CPU: the cascade's
configuration on 128x192 canvases, batches of 2, a pool of small images."""
import copy
import json
import os

from kgbench import spec

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SIZES = [[60, 80], [75, 100], [96, 128], [90, 160]]


def _json(*parts):
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def config():
    cfg = _json('kgbench', 'configs', 'kgdet_cascade_r50.json')
    data = {'img_scale': [190, 128], 'canvases': [[128, 192], [192, 128]]}
    for split in ('val_data', 'train_data'):
        cfg['overrides'].update({f'{split}.img_scale': data['img_scale'],
                                 f'{split}.canvas_hw': data['canvases']})
        for k in ('img_scale', 'canvas_hw'):
            cfg['holds'].pop(f'{split}.{k}')
    cfg['overrides']['train_data.batch_size'] = 2
    cfg['holds'].pop('train_data.batch_size')
    cfg['train']['batch_size'] = 2
    cfg['data'] = data
    return cfg


def offline_mix():
    mix = _json('kgbench', 'traffic', 'serve_b8.json')
    mix.update(sizes=SIZES, batch=2)
    return mix


def online_mix():
    mix = _json('kgbench', 'traffic', 'serve_online.json')
    mix.update(sizes=SIZES, pool=8, rate_per_s=5.0, sampled_requests=3)
    return mix


def train_mix():
    mix = _json('kgbench', 'traffic', 'train_b8.json')
    mix.update(sizes=SIZES, files=16, records=80, warmup_steps_per_canvas=1)
    return mix


def cell(mix):
    return spec.Cell(root=ROOT, name='tiny', chips=1, config=config(),
                     traffic=copy.deepcopy(mix))
