"""FPN neck with level selection (FPN2 ``select_out``).

Port of kgdet_tpu/models/fpn.py: lateral 1x1 + nearest-2x top-down + 3x3
output convs, extra stride-2 convs for the levels above the backbone
(``fpn_convs.<used>...``), optional GN. Module names follow the reference
(lateral_convs.<i>, fpn_convs.<i>).

Only the levels that ``select_out`` returns are computed, with what they
depend on; with ``select_out=(2,)`` that is P5 from C5 alone. The extra
convs still exist as parameters, so checkpoints map one to one.
"""
from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from kgdet_tpu_torch.models.layers import ConvModule, init_xavier_uniform_


class FPN(nn.Module):
    def __init__(self, in_channels, out_channels=256, num_outs=5,
                 start_level=0, end_level=-1, add_extra_convs=False,
                 select_out=None, norm=None, gn_groups=32):
        super().__init__()
        self.in_channels = tuple(in_channels)
        self.num_outs = num_outs
        self.start_level = start_level
        self.end = len(in_channels) if end_level == -1 else end_level
        self.used = self.end - start_level
        self.add_extra_convs = add_extra_convs
        self.select_out = None if select_out is None else tuple(select_out)

        def cm(cin, k, stride):
            return ConvModule(cin, out_channels, k, stride, norm=norm,
                              gn_groups=gn_groups, act=False)

        self.lateral_convs = nn.ModuleList(
            cm(in_channels[i + start_level], 1, 1) for i in range(self.used))
        fpn = [cm(out_channels, 3, 1) for _ in range(self.used)]
        if add_extra_convs:
            # the first extra conv reads the last backbone input (the
            # reference's extra_convs_on_inputs=True), the rest the level
            # below
            fpn += [cm(in_channels[self.end - 1] if i == self.used
                       else out_channels, 3, 2)
                    for i in range(self.used, num_outs)]
        self.fpn_convs = nn.ModuleList(fpn)

    @classmethod
    def from_config(cls, ncfg):
        return cls(in_channels=ncfg.in_channels,
                   out_channels=ncfg.out_channels,
                   start_level=ncfg.start_level, end_level=ncfg.end_level,
                   num_outs=ncfg.num_outs,
                   add_extra_convs=ncfg.add_extra_convs,
                   select_out=ncfg.select_out, norm=ncfg.norm,
                   gn_groups=ncfg.gn_groups)

    def init_weights(self, gen):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                init_xavier_uniform_(m.weight, gen)

    def forward(self, inputs):
        assert len(inputs) == len(self.in_channels)
        used = self.used
        want = (self.select_out if self.select_out is not None
                else tuple(range(self.num_outs)))
        top = max(want)
        # max-pooled extra levels are built on the top pyramid level
        pool_top = top >= used and not self.add_extra_convs
        lo = min([i for i in want if i < used]
                 + [used - 1 if pool_top else used])

        laterals = {i: self.lateral_convs[i](inputs[i + self.start_level])
                    for i in range(lo, used)}
        for i in range(used - 1, lo, -1):
            laterals[i - 1] = laterals[i - 1] + F.interpolate(
                laterals[i], scale_factor=2, mode='nearest')
        outs = {i: self.fpn_convs[i](laterals[i]) for i in range(lo, used)
                if i in want or (pool_top and i == used - 1)}
        for i in range(used, top + 1):
            if not self.add_extra_convs:
                outs[i] = F.max_pool2d(outs[i - 1], 1, stride=2)
            else:
                outs[i] = self.fpn_convs[i](
                    inputs[self.end - 1] if i == used else outs[i - 1])
        return tuple(outs[i] for i in want)
