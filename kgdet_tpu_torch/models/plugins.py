"""Backbone plugins: the GCNet context block, the non-local block and
GeneralizedAttention ("empirical attention").

Port of kgdet_tpu/models/plugins.py, on NCHW maps, under the reference's
names (mmdet ops/context_block.py: conv_mask, channel_add_conv.0 / .1 /
.3; plugins/non_local.py: g / theta / phi / conv_out ConvModules;
plugins/generalized_attention.py: query_conv, key_conv, value_conv,
proj_conv, appr_geom_fc_x / _y, appr_bias, geom_bias, gamma). Softmax,
layer norm and the attention energies are taken in f32. Where the JAX
module departs from the reference the port follows it: GeneralizedAttention
strides its key / value map by slicing (the reference average-pools), and
the context block's layer norm has flax's eps 1e-6.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from kgdet_tpu_torch.models.layers import ConvModule, \
    init_variance_scaling_


def _conv1x1(x, conv):
    dt = x.dtype
    return F.conv2d(x, conv.weight.to(dt),
                    None if conv.bias is None else conv.bias.to(dt))


class ContextBlock(nn.Module):
    """GCNet: attention-pooled global context through a bottleneck
    transform, added to (``channel_add``) or gating (``channel_mul``) every
    position."""

    def __init__(self, in_channels: int, ratio: float = 1.0 / 16,
                 pooling_type: str = 'att',
                 fusion_types=('channel_add',)):
        super().__init__()
        planes = max(int(in_channels * ratio), 1)
        self.pooling_type = pooling_type
        self.fusion_types = tuple(fusion_types)
        if pooling_type == 'att':
            self.conv_mask = nn.Conv2d(in_channels, 1, 1)
        for fusion in self.fusion_types:
            if fusion not in ('channel_add', 'channel_mul'):
                raise ValueError(fusion)
            setattr(self, f'{fusion}_conv', nn.Sequential(
                nn.Conv2d(in_channels, planes, 1),
                nn.LayerNorm([planes, 1, 1], eps=1e-6), nn.ReLU(),
                nn.Conv2d(planes, in_channels, 1)))

    def init_weights(self, gen):
        """flax's defaults (lecun normal, zero biases, unit norm), the last
        conv of each fusion zero."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                init_variance_scaling_(m.weight, gen)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        for fusion in self.fusion_types:
            nn.init.zeros_(getattr(self, f'{fusion}_conv')[3].weight)

    def forward(self, x):
        B, C = x.shape[:2]
        if self.pooling_type == 'att':
            attn = torch.softmax(_conv1x1(x, self.conv_mask).float()
                                 .reshape(B, -1, 1), dim=1).to(x.dtype)
            context = (x.reshape(B, C, -1) @ attn).reshape(B, C, 1, 1)
        else:
            context = x.mean(dim=(2, 3), keepdim=True)
        out = x
        for fusion in self.fusion_types:
            conv1, ln, _, conv2 = getattr(self, f'{fusion}_conv')
            t = _conv1x1(context, conv1)
            t = F.layer_norm(t.float(), ln.normalized_shape, ln.weight,
                             ln.bias, ln.eps).to(x.dtype)
            t = _conv1x1(torch.relu(t), conv2)
            out = out + t if fusion == 'channel_add' \
                else out * torch.sigmoid(t)
        return out


class NonLocal2D(nn.Module):
    """Embedded-gaussian non-local block: x + conv_out(softmax(theta(x)
    phi(x)^T / sqrt(inter)) g(x)), conv_out zero at init."""

    def __init__(self, in_channels: int, reduction: int = 2,
                 use_scale: bool = True):
        super().__init__()
        inter = max(in_channels // reduction, 1)
        self.inter = inter
        self.use_scale = use_scale
        for name in ('g', 'theta', 'phi'):
            setattr(self, name, ConvModule(in_channels, inter, 1, act=False))
        self.conv_out = ConvModule(inter, in_channels, 1, act=False)

    def init_weights(self, gen):
        for m in (self.g, self.theta, self.phi):
            init_variance_scaling_(m.conv.weight, gen)
            nn.init.zeros_(m.conv.bias)
        nn.init.zeros_(self.conv_out.conv.weight)
        nn.init.zeros_(self.conv_out.conv.bias)

    def forward(self, x):
        B, _, H, W = x.shape

        def flat(m):                                    # (B, P, inter)
            return m(x).reshape(B, self.inter, H * W).transpose(1, 2)
        attn = flat(self.theta).float() @ flat(self.phi).float() \
            .transpose(1, 2)
        if self.use_scale:
            attn = attn / math.sqrt(float(self.inter))
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        y = (attn @ flat(self.g)).transpose(1, 2).reshape(B, self.inter, H,
                                                          W)
        return x + self.conv_out(y)


class GeneralizedAttention(nn.Module):
    """Empirical attention: the query-key, query-position, bias-key and
    bias-position terms that ``attention_type`` selects, over key / value
    maps strided by ``kv_stride``, with sinusoidal embeddings of the
    relative positions; gamma (zero at init) scales the result onto x."""

    def __init__(self, in_channels: int, num_heads: int = 9,
                 spatial_range: int = -1, kv_stride: int = 2,
                 q_stride: int = 1, attention_type: str = '1111',
                 position_magnitude: float = 1.0,
                 position_embedding_dim: int = -1):
        super().__init__()
        self.num_heads = num_heads
        self.d = in_channels // num_heads
        self.spatial_range = spatial_range
        self.kv_stride = kv_stride
        self.q_stride = q_stride
        self.position_magnitude = position_magnitude
        self.at = [c == '1' for c in attention_type]
        self.pe_dim = position_embedding_dim if position_embedding_dim > 0 \
            else in_channels
        hd = num_heads * self.d
        at = self.at
        if at[0] or at[1]:
            self.query_conv = nn.Conv2d(in_channels, hd, 1, bias=False)
        if at[0] or at[2]:
            self.key_conv = nn.Conv2d(in_channels, hd, 1, bias=False)
        if at[2]:
            self.appr_bias = nn.Parameter(torch.zeros(hd))
        if at[3]:
            self.geom_bias = nn.Parameter(torch.zeros(hd))
        if at[1] or at[3]:
            emb = 2 * (self.pe_dim // 4)
            self.appr_geom_fc_x = nn.Linear(emb, hd, bias=False)
            self.appr_geom_fc_y = nn.Linear(emb, hd, bias=False)
        self.value_conv = nn.Conv2d(in_channels, hd, 1, bias=False)
        self.proj_conv = nn.Conv2d(hd, in_channels, 1)
        self.gamma = nn.Parameter(torch.zeros(1))

    def init_weights(self, gen):
        """The JAX inits: uniform fan-in (scale 1) weights, the two biases
        uniform in +-1/sqrt(2 d), zero gamma and projection bias."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                init_variance_scaling_(m.weight, gen,
                                       distribution='uniform')
        stdv = 1.0 / math.sqrt(self.d * 2)
        for name in ('appr_bias', 'geom_bias'):
            if hasattr(self, name):
                with torch.no_grad():
                    p = getattr(self, name)
                    p.copy_(torch.rand(p.shape, generator=gen) * 2 * stdv
                            - stdv)
        nn.init.zeros_(self.proj_conv.bias)
        nn.init.zeros_(self.gamma)

    def _pos_embedding(self, n_q, n_kv, device):
        """(n_q, n_kv, 2 * (dim // 4)) sinusoidal embedding of the strided
        coordinate differences, [sin | cos]."""
        q_idx = torch.arange(n_q, dtype=torch.float32, device=device) \
            * self.q_stride
        kv_idx = torch.arange(n_kv, dtype=torch.float32, device=device) \
            * self.kv_stride
        diff = (q_idx[:, None] - kv_idx[None, :]) * self.position_magnitude
        feat_range = torch.arange(self.pe_dim // 4, dtype=torch.float32,
                                  device=device)
        dim_mat = 1000.0 ** ((4.0 / self.pe_dim) * feat_range)
        phase = diff[..., None] / dim_mat
        return torch.cat([torch.sin(phase), torch.cos(phase)], dim=-1)

    def forward(self, x):
        dt, f32 = x.dtype, torch.float32
        x_nhwc = x.permute(0, 2, 3, 1)
        B, _, _, C = x_nhwc.shape
        n, d, at = self.num_heads, self.d, self.at
        x_q = x_nhwc[:, ::self.q_stride, ::self.q_stride]
        x_kv = x_nhwc[:, ::self.kv_stride, ::self.kv_stride]
        h, w = x_q.shape[1:3]
        hk, wk = x_kv.shape[1:3]

        def dense(t, conv):
            return F.linear(t, conv.weight[:, :, 0, 0].to(dt))
        energy = torch.zeros((B, n, h, w, hk, wk), dtype=f32,
                             device=x.device)
        if at[0] or at[1]:
            q = dense(x_q, self.query_conv).reshape(B, h, w, n, d).to(f32)
        if at[0] or at[2]:
            k = dense(x_kv, self.key_conv).reshape(B, hk, wk, n, d).to(f32)
        if at[2]:
            appr_bias = self.appr_bias.reshape(n, d)
        if at[3]:
            geom_bias = self.geom_bias.reshape(n, d)
        if at[1] or at[3]:
            def pos(n_q, n_kv, fc):
                emb = self._pos_embedding(n_q, n_kv, x.device).to(dt)
                return F.linear(emb, fc.weight.to(dt)).reshape(
                    n_q, n_kv, n, d).to(f32) / math.sqrt(2)
            pos_x = pos(w, wk, self.appr_geom_fc_x)
            pos_y = pos(h, hk, self.appr_geom_fc_y)
        if at[0]:
            qq = q + appr_bias if at[2] else q
            energy = energy + torch.einsum('byxnd,bijnd->bnyxij', qq, k)
        elif at[2]:
            energy = energy + torch.einsum(
                'nd,bijnd->bnij', appr_bias, k)[:, :, None, None]
        if at[1]:
            qg = q + geom_bias if at[3] else q
            energy = energy + torch.einsum(
                'byxnd,xjnd->bnyxj', qg, pos_x)[:, :, :, :, None, :]
            energy = energy + torch.einsum(
                'byxnd,yind->bnyxi', qg, pos_y)[..., None]
        elif at[3]:
            energy = energy + torch.einsum(
                'nd,xjnd->nxj', geom_bias, pos_x)[None, :, None, :, None, :]
            energy = energy + torch.einsum(
                'nd,yind->nyi', geom_bias, pos_y)[None, :, :, None, :, None]
        if self.spatial_range >= 0:
            dev = x.device
            iy = torch.arange(h, device=dev)[:, None, None, None] \
                * self.q_stride
            ix = torch.arange(w, device=dev)[None, :, None, None] \
                * self.q_stride
            ky = torch.arange(hk, device=dev)[None, None, :, None]
            kx = torch.arange(wk, device=dev)[None, None, None, :]
            sr, kvs = self.spatial_range, self.kv_stride
            ok = ((ky >= ((iy - sr) // kvs).clamp(min=0))
                  & (ky < (iy + sr + 1) // kvs + 1)
                  & (kx >= ((ix - sr) // kvs).clamp(min=0))
                  & (kx < (ix + sr + 1) // kvs + 1))
            energy = torch.where(ok, energy, -torch.inf)
        attn = torch.softmax(energy.reshape(B, n, h * w, hk * wk), dim=-1)
        v = dense(x_kv, self.value_conv).reshape(B, hk * wk, n, d).to(f32)
        out = torch.einsum('bnpq,bqnd->bpnd', attn, v).reshape(
            B, h, w, n * d)
        out = F.linear(out.to(dt), self.proj_conv.weight[:, :, 0, 0].to(dt),
                       self.proj_conv.bias.to(dt))
        return self.gamma.to(dt) * out.permute(0, 3, 1, 2) + x
