"""The plain reference of the PETR detector: fp32 PyTorch, no kernels.

A frozen copy of the port's plain model code (``petr_tpu_torch/models/
{detector,vovnet,resnet,fpn,petr_head,transformer,layers}.py`` and
``ops/{geometry,boxes,nms_free,dcn,cross_attention}.py`` as of the
benchmark's first version), with every kernel call replaced by its plain
version and the parts no cell runs left out (sharding, int8, the K5 route,
PETRv2, Depthr, batch-moments BN, remat). It imports nothing of the port:
the benchmark hands both the same weights, by the port's parameter names,
which this copy keeps.

It computes in fp32 throughout. ``operand_rounding`` switches it to the
control: every product (convolutions, linear maps, attention products, the
deformable conv's contraction) computed in float8 e4m3, operands and result
rounded with a per-tensor scale, the precision below the configuration's
bfloat16.

Training-mode randomness is the port's, drawn again here: GridMask from the
step's CPU generator (``draw_train_noise``), each decoder layer's dropouts
from a generator on the device seeded as the port seeds it, and the
cross-attention's dropout from the kernels' hash of (seed, b*H + h, query,
key). A forward may run on one sample ``row`` of a batch of ``batch``: it
then draws the whole batch's masks and keeps that row's, so that a batch
can be stepped one sample at a time.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from collections import OrderedDict
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# ------------------------------------------------------------ precision
_ROUND = {"on": False}
FP8_MAX = 448.0


@contextlib.contextmanager
def operand_rounding(enabled: bool = True):
    """Compute every product in float8 e4m3 inside the block (the control):
    its operands and its result rounded to e4m3, the sum in fp32, as an fp8
    tensor core takes and stores them; gradients pass straight through the
    rounding."""
    old = _ROUND["on"]
    _ROUND["on"] = enabled
    try:
        yield
    finally:
        _ROUND["on"] = old


def rnd(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a product's operand: itself, or under ``operand_rounding``
    rounded to e4m3 at a per-tensor scale that maps its largest value to the
    format's largest."""
    if not _ROUND["on"]:
        return x
    with torch.no_grad():
        scale = x.detach().abs().amax().float().clamp(min=1e-30) / FP8_MAX
        q = (x.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q.to(x.dtype) - x).detach()


@contextlib.contextmanager
def exact_fp32():
    """TF32 off for matmuls and cuDNN convolutions inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


# ---------------------------------------------------------------- layers
class Linear(nn.Linear):
    def forward(self, x):
        return rnd(F.linear(rnd(x), rnd(self.weight), self.bias))


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return rnd(F.conv2d(rnd(x), rnd(self.weight), self.bias, self.stride, self.padding, self.dilation, self.groups))


class PointwiseConv2d(nn.Conv2d):
    """A 1x1 conv (O, I, 1, 1) applied to channels-last input as a linear map."""

    def __init__(self, cin, cout):
        super().__init__(cin, cout, 1)

    def forward(self, x):
        return rnd(F.linear(rnd(x), rnd(self.weight[:, :, 0, 0]), self.bias))


class LayerNorm(nn.LayerNorm):
    def __init__(self, n, eps=1e-6):
        super().__init__(n, eps=eps)


class FrozenBatchNorm(nn.Module):
    def __init__(self, n, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def forward(self, x):
        mul = self.weight * torch.rsqrt(self.running_var + self.eps)
        add = self.bias - self.running_mean * mul
        return x * mul[:, None, None] + add[:, None, None]


def conv_bn_relu(name, cin, cout, kernel=3, stride=1, relu=True):
    layers = [(f"{name}/conv", Conv2d(cin, cout, kernel, stride, kernel // 2, bias=False)),
              (f"{name}/norm", FrozenBatchNorm(cout))]
    if relu:
        layers.append((f"{name}/relu", nn.ReLU()))
    return nn.Sequential(OrderedDict(layers))


def mlp(cin, features, pointwise=False):
    layers = []
    for i, f in enumerate(features):
        layers.append(PointwiseConv2d(cin, f) if pointwise else Linear(cin, f))
        if i < len(features) - 1:
            layers.append(nn.ReLU())
        cin = f
    return nn.Sequential(*layers)


# ----------------------------------------------------------- dropout
def dropout(x, rate, gen, batch, row):
    """flax Dropout with the mask of the whole batch's draw, at ``row``."""
    if row is None:
        keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
    else:
        keep = (torch.rand((batch, *x.shape[1:]), generator=gen, device=x.device) >= rate)[row:row + 1]
    return torch.where(keep, x / (1.0 - rate), 0.0)


_M32 = 0xFFFFFFFF


def _mul32(a, c):
    lo = a * (c & 0xFFFF)
    hi = (a * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def hash_keep(seed, B, H, Q, L, rate, device, b0=0):
    """The (B, H, Q, L) keep mask of the cross-attention's dropout hash
    (the kernels' and ``_dropout_keep``'s uint32 arithmetic), rows of the
    batch from ``b0``."""
    bh = torch.arange(b0 * H, (b0 + B) * H, dtype=torch.int64, device=device).view(B, H, 1, 1)
    rows = torch.arange(Q, dtype=torch.int64, device=device).view(1, 1, Q, 1)
    cols = torch.arange(L, dtype=torch.int64, device=device).view(1, 1, 1, L)
    seed = int(seed) & _M32
    mix = ((seed * 0x85EBCA6B) & _M32) + _mul32(bh & _M32, 0xC2B2AE35)
    h = (_mul32(rows, 0x9E3779B9) + cols + mix) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h >= min(int(rate * 4294967296.0), 4294967295)


# ---------------------------------------------------------------- VoVNet
VOV_SPECS = {
    "V-99-eSE": dict(stem=(64, 64, 128), conv=(128, 160, 192, 224), out=(256, 512, 768, 1024), layers=5,
                     blocks=(1, 3, 9, 3)),
    "V-39-eSE": dict(stem=(64, 64, 128), conv=(128, 160, 192, 224), out=(256, 512, 768, 1024), layers=5,
                     blocks=(1, 1, 2, 2)),
}


class ESE(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.fc = Conv2d(c, c, 1)

    def forward(self, x):
        return x * ((self.fc(x.mean(dim=(-2, -1), keepdim=True)) + 3.0).clamp(0.0, 6.0) / 6.0)


class OSABlock(nn.Module):
    def __init__(self, name, cin, stage_ch, concat_ch, n_layers, identity):
        super().__init__()
        self.identity = identity
        self.layers = nn.ModuleList(conv_bn_relu(f"{name}_{i}", cin if i == 0 else stage_ch, stage_ch)
                                    for i in range(n_layers))
        self.concat = conv_bn_relu(f"{name}_concat", cin + n_layers * stage_ch, concat_ch, kernel=1)
        self.ese = ESE(concat_ch)

    def forward(self, x):
        feats, y = [x], x
        for layer in self.layers:
            y = layer(y)
            feats.append(y)
        y = self.ese(self.concat(torch.cat(feats, dim=1)))
        return y + x if self.identity else y


class VoVNet(nn.Module):
    def __init__(self, spec, out_indices):
        super().__init__()
        s = VOV_SPECS[spec]
        self.out_indices = tuple(out_indices)
        s0, s1, s2 = s["stem"]
        stem = [conv_bn_relu("stem_1", 3, s0, stride=2), conv_bn_relu("stem_2", s0, s1),
                conv_bn_relu("stem_3", s1, s2, stride=2)]
        self.stem = nn.Sequential(OrderedDict((n, m) for c in stem for n, m in c.named_children()))
        cin = s2
        for stage in range(4):
            blocks = OrderedDict()
            for b in range(s["blocks"][stage]):
                name = f"OSA{stage + 2}_{b + 1}"
                blocks[name] = OSABlock(name, cin, s["conv"][stage], s["out"][stage], s["layers"], b > 0)
                cin = s["out"][stage]
            self.add_module(f"stage{stage + 2}", nn.Sequential(blocks))
        self.channels = tuple(s["out"][i] for i in self.out_indices)

    def forward(self, x):
        x = self.stem(x)
        outs = []
        for stage in range(4):
            if stage > 0:
                x = F.max_pool2d(x, 3, 2, ceil_mode=True)
            x = getattr(self, f"stage{stage + 2}")(x)
            if stage in self.out_indices:
                outs.append(x)
        return outs


# ----------------------------------------------------- ResNet with DCNv2
def deform_conv(x, off_mask, weight, stride=1):
    """DCNv2 (3x3, padding 1, dilation 1) by ``grid_sample``: each tap's
    modulated samples, bilinear with zeros outside the plane, contracted
    with the weight. off_mask holds the interleaved (dy, dx) of the 9 taps,
    then their 9 mask logits."""
    B, Cin, H, W = x.shape
    Cout = weight.shape[0]
    Ho, Wo = off_mask.shape[-2:]
    dev = x.device
    oy = torch.arange(Ho, dtype=torch.float32, device=dev) * stride
    ox = torch.arange(Wo, dtype=torch.float32, device=dev) * stride
    cols = []
    for k in range(9):
        ty, tx = k // 3 - 1, k % 3 - 1
        sy = oy[None, :, None] + ty + off_mask[:, 2 * k]
        sx = ox[None, None, :] + tx + off_mask[:, 2 * k + 1]
        grid = torch.stack([2.0 * sx / (W - 1) - 1.0, 2.0 * sy / (H - 1) - 1.0], dim=-1)
        s = F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros", align_corners=True)
        cols.append(s * torch.sigmoid(off_mask[:, 18 + k])[:, None])
    samples = torch.stack(cols, dim=2).reshape(B, Cin * 9, Ho, Wo)  # channel-major, tap-minor
    return rnd(F.conv2d(rnd(samples), rnd(weight.reshape(Cout, Cin * 9, 1, 1))))


class DeformConv(Conv2d):
    def __init__(self, cin, cout):
        super().__init__(cin, cout, 3, 1, 1, bias=False)
        self.conv_offset = Conv2d(cin, 27, 3, 1, 1)

    def forward(self, x):
        return deform_conv(x, self.conv_offset(x), self.weight)


class Bottleneck(nn.Module):
    def __init__(self, cin, mid, out, stride, dcn):
        super().__init__()
        self.conv1 = Conv2d(cin, mid, 1, stride, bias=False)
        self.bn1 = FrozenBatchNorm(mid)
        self.conv2 = DeformConv(mid, mid) if dcn else Conv2d(mid, mid, 3, 1, 1, bias=False)
        self.bn2 = FrozenBatchNorm(mid)
        self.conv3 = Conv2d(mid, out, 1, bias=False)
        self.bn3 = FrozenBatchNorm(out)
        self.downsample = None
        if cin != out or stride != 1:
            self.downsample = nn.Sequential(Conv2d(cin, out, 1, stride, bias=False), FrozenBatchNorm(out))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + (x if self.downsample is None else self.downsample(x)))


class ResNet(nn.Module):
    def __init__(self, depth, out_indices, dcn_stages):
        super().__init__()
        blocks = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}[depth]
        self.out_indices = tuple(out_indices)
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        cin, mid = 64, 64
        for stage, n in enumerate(blocks):
            layers = []
            for b in range(n):
                layers.append(Bottleneck(cin, mid, 4 * mid, 2 if stage > 0 and b == 0 else 1, stage in dcn_stages))
                cin = 4 * mid
            self.add_module(f"layer{stage + 1}", nn.Sequential(*layers))
            mid *= 2
        self.channels = tuple((256, 512, 1024, 2048)[i] for i in self.out_indices)

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        outs = []
        for stage in range(4):
            x = getattr(self, f"layer{stage + 1}")(x)
            if stage in self.out_indices:
                outs.append(x)
        return outs


# ----------------------------------------------------------------- CPFPN
class ConvModule(nn.Module):
    def __init__(self, cin, cout, kernel):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel, padding=kernel // 2)

    def forward(self, x):
        return self.conv(x)


class CPFPN(nn.Module):
    def __init__(self, in_channels, out_channels, num_outs):
        super().__init__()
        self.num_outs = num_outs
        self.lateral_convs = nn.ModuleList(ConvModule(c, out_channels, 1) for c in in_channels)
        self.fpn_convs = nn.ModuleList([ConvModule(out_channels, out_channels, 3)])

    def forward(self, inputs):
        lat = [conv(x) for conv, x in zip(self.lateral_convs, inputs)]
        for i in range(len(lat) - 1, 0, -1):
            lat[i - 1] = lat[i - 1] + F.interpolate(lat[i], size=tuple(lat[i - 1].shape[-2:]), mode="nearest-exact")
        outs = [self.fpn_convs[0](lat[0])] + lat[1:]
        while len(outs) < self.num_outs:
            outs.append(F.max_pool2d(outs[-1], 1, 2))
        return outs[: self.num_outs]


# -------------------------------------------------------------- geometry
def inverse_sigmoid(x, eps=1e-5):
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))


def _dim_t(n, temperature, device):
    d = torch.arange(n, dtype=torch.float32, device=device)
    return temperature ** (2.0 * torch.floor(d / 2.0) / n)


def pos2posemb3d(pos, num_feats=128, temperature=10000.0):
    pos = pos.float() * (2.0 * math.pi)

    def inter(p):
        ang = p[..., None] / _dim_t(num_feats, temperature, p.device)
        return torch.stack([ang[..., 0::2].sin(), ang[..., 1::2].cos()], dim=-1).flatten(-2)

    return torch.cat([inter(pos[..., 1]), inter(pos[..., 0]), inter(pos[..., 2])], dim=-1)


def position_coords_3d(fh, fw, pad_h, pad_w, img2lidar, position_range, depth_num, depth_start):
    """Normalised frustum points (B, N, fh, fw, D*3), LID depth bins."""
    dev = img2lidar.device
    pr = torch.tensor(position_range, dtype=torch.float32, device=dev)
    idx = torch.arange(depth_num, dtype=torch.float32, device=dev)
    d = depth_start + (float(position_range[3]) - depth_start) / (depth_num * (1 + depth_num)) * idx * (idx + 1.0)
    ch = torch.arange(fh, dtype=torch.float32, device=dev) * (pad_h / fh)
    cw = torch.arange(fw, dtype=torch.float32, device=dev) * (pad_w / fw)
    shape = (fh, fw, depth_num)
    dm = d.clamp(min=1e-5)[None, None, :]
    coords = torch.stack([(cw[None, :, None] * dm).expand(shape), (ch[:, None, None] * dm).expand(shape),
                          d[None, None, :].expand(shape), torch.ones(shape, device=dev)], dim=-1)
    pts = torch.einsum("...ij,hwdj->...hwdi", img2lidar.float(), coords)[..., :3]
    return ((pts - pr[0:3]) / (pr[3:6] - pr[0:3])).flatten(-2)


def sine_posemb_2d_multiview(masks, num_feats, temperature=10000.0, eps=1e-6):
    not_mask = 1.0 - masks.float()
    n = not_mask.cumsum(1)
    y = not_mask.cumsum(2)
    x = not_mask.cumsum(3)
    s = 2.0 * math.pi
    n = n / (n[:, -1:, :, :] + eps) * s
    y = y / (y[:, :, -1:, :] + eps) * s
    x = x / (x[:, :, :, -1:] + eps) * s

    def block(p):
        ang = p[..., None] / _dim_t(num_feats, temperature, p.device)
        return torch.cat([ang[..., 0::2].sin(), ang[..., 1::2].cos()], dim=-1)

    return torch.cat([block(n), block(y), block(x)], dim=-1)


# ------------------------------------------------------------ transformer
@dataclasses.dataclass
class Noise:
    """One training forward's randomness, as the port draws it."""

    grid: Optional[Tuple[bool, int, int, int]]  # (apply, d, st_h, st_w) or None
    layer_seeds: Tuple[Tuple[int, int], ...]
    batch: int  # the batch the masks are drawn for
    row: Optional[int] = None  # the sample this forward runs on, or None for all


class AttentionProjections(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * c, c))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * c))
        self.out_proj = Linear(c, c)


class MultiheadAttention(nn.Module):
    """q/k/v projections, dense fp32 attention and the output projection.
    ``cross``: the flash kernels' semantics (a fully masked row gives 0) and
    their hashed dropout; otherwise the plain branch's dropout of the
    probabilities from the layer's generator."""

    def __init__(self, c, heads, cross):
        super().__init__()
        self.c, self.heads, self.cross = c, heads, cross
        self.attn = AttentionProjections(c)

    def forward(self, query, key, value, mask=None, rate=0.0, flash_seed=None, gen=None, noise=None):
        C, H = self.c, self.heads
        D = C // H
        w, b = self.attn.in_proj_weight, self.attn.in_proj_bias
        q = rnd(F.linear(rnd(query), rnd(w[:C]), b[:C]))
        k = rnd(F.linear(rnd(key), rnd(w[C:2 * C]), b[C:2 * C]))
        v = rnd(F.linear(rnd(value), rnd(w[2 * C:]), b[2 * C:]))
        B, Q, L = q.shape[0], q.shape[1], k.shape[1]
        q = q.view(B, Q, H, D).transpose(1, 2)
        k = k.view(B, L, H, D).transpose(1, 2)
        v = v.view(B, L, H, D).transpose(1, 2)
        s = rnd(torch.matmul(q * (1.0 / math.sqrt(D)), k.transpose(-1, -2)))
        if self.cross:
            if mask is not None:
                s = s.masked_fill(mask[:, None, None, :], -1e30)
            m = s.amax(-1, keepdim=True)
            p = torch.exp(s - m)
            if mask is not None:
                p = p.masked_fill(mask[:, None, None, :], 0.0)
            l = p.sum(-1, keepdim=True)
            if rate > 0.0:
                b0 = 0 if noise.row is None else noise.row
                keep = hash_keep(flash_seed, B, H, Q, L, rate, q.device, b0)
                p = torch.where(keep, p / (1.0 - rate), 0.0)
            out = rnd(torch.matmul(rnd(p), v)) / l.clamp(min=1e-20)
        else:
            if mask is not None:
                s = s.masked_fill(mask[:, None, None, :], torch.finfo(torch.float32).min)
            p = s.softmax(-1)
            if rate > 0.0:
                p = dropout(p, rate, gen, noise.batch, noise.row)
            out = rnd(torch.matmul(rnd(p), v))
        return self.attn.out_proj(out.transpose(1, 2).reshape(B, Q, C))


class FFN(nn.Module):
    def __init__(self, c, hidden):
        super().__init__()
        self.layers = nn.Sequential(nn.Sequential(Linear(c, hidden), nn.ReLU()), Linear(hidden, c))

    def forward(self, x, rate=0.0, gen=None, noise=None):
        y = self.layers[0](x)
        if rate > 0.0:
            y = dropout(y, rate, gen, noise.batch, noise.row)
        y = self.layers[1](y)
        if rate > 0.0:
            y = dropout(y, rate, gen, noise.batch, noise.row)
        return y


class DecoderLayer(nn.Module):
    def __init__(self, c, heads, ffn_dim, rate):
        super().__init__()
        self.rate = rate
        self.attentions = nn.ModuleList([MultiheadAttention(c, heads, False), MultiheadAttention(c, heads, True)])
        self.ffns = nn.ModuleList([FFN(c, ffn_dim)])
        self.norms = nn.ModuleList(LayerNorm(c) for _ in range(3))

    def forward(self, query, memory, query_pos, key_pos, mask, seeds, noise):
        rate, flash_seed, gen = 0.0, None, None
        if self.training and self.rate > 0.0:
            rate, flash_seed = self.rate, seeds[0]
            gen = torch.Generator(device=query.device)
            gen.manual_seed(seeds[1])
        q_in = query + query_pos
        sa = self.attentions[0](q_in, q_in, query, rate=rate, gen=gen, noise=noise)
        if rate > 0.0:
            sa = dropout(sa, rate, gen, noise.batch, noise.row)
        query = self.norms[0](query + sa)
        ca = self.attentions[1](query + query_pos, memory + key_pos, memory, mask, rate, flash_seed, gen, noise)
        if rate > 0.0:
            ca = dropout(ca, rate, gen, noise.batch, noise.row)
        query = self.norms[1](query + ca)
        return self.norms[2](query + self.ffns[0](query, rate, gen, noise))


class Decoder(nn.Module):
    def __init__(self, n, c, heads, ffn_dim, rate):
        super().__init__()
        self.layers = nn.ModuleList(DecoderLayer(c, heads, ffn_dim, rate) for _ in range(n))
        self.post_norm = LayerNorm(c)

    def forward(self, query, memory, query_pos, key_pos, mask, noise):
        outs = []
        for i, layer in enumerate(self.layers):
            seeds = None if noise is None else noise.layer_seeds[i]
            query = layer(query, memory, query_pos, key_pos, mask, seeds, noise)
            outs.append(self.post_norm(query))
        return torch.stack(outs, dim=0)


class Transformer(nn.Module):
    def __init__(self, n, c, heads, ffn_dim, rate):
        super().__init__()
        self.decoder = Decoder(n, c, heads, ffn_dim, rate)


class ClsBranch(nn.Sequential):
    def __init__(self, c, out):
        super().__init__(Linear(c, c), LayerNorm(c), nn.ReLU(), Linear(c, c), LayerNorm(c), nn.ReLU(), Linear(c, out))


class RegBranch(nn.Sequential):
    def __init__(self, c, out):
        super().__init__(Linear(c, c), nn.ReLU(), Linear(c, c), nn.ReLU(), Linear(c, out))


class PETRHead(nn.Module):
    def __init__(self, hc, in_channels):
        super().__init__()
        c = hc["embed_dim"]
        self.hc = hc
        self.input_proj = PointwiseConv2d(in_channels, c)
        self.position_encoder = mlp(hc["depth_num"] * 3, (4 * c, c), pointwise=True)
        self.adapt_pos3d = mlp(c * 3 // 2, (4 * c, c), pointwise=True)
        self.reference_points = nn.Embedding(hc["num_query"], 3)
        self.query_embedding = mlp(384, (c, c))
        self.transformer = Transformer(hc["num_layers"], c, hc["num_heads"], hc["ffn_dim"], hc["dropout_rate"])
        cls, reg = ClsBranch(c, hc["num_classes"]), RegBranch(c, hc["code_size"])
        self.cls_branches = nn.ModuleList([cls] * hc["num_layers"])
        self.reg_branches = nn.ModuleList([reg] * hc["num_layers"])

    def forward(self, feats, img2lidar, img_hw, pad_hw, noise=None):
        hc = self.hc
        B, N, H, W, _ = feats.shape
        pad_h, pad_w = pad_hw
        dev = feats.device
        ys = torch.arange(H, dtype=torch.float32, device=dev) * (pad_h / H)
        xs = torch.arange(W, dtype=torch.float32, device=dev) * (pad_w / W)
        img_hw = img_hw.float()
        masks = ~((ys[None, None, :] < img_hw[..., 0:1])[..., :, None] & (xs[None, None, :] < img_hw[..., 1:2])[..., None, :])
        x = self.input_proj(feats)
        coords = position_coords_3d(H, W, float(pad_h), float(pad_w), img2lidar, hc["position_range"],
                                    hc["depth_num"], hc["depth_start"])
        pos = self.position_encoder(inverse_sigmoid(coords))
        pos = pos + self.adapt_pos3d(sine_posemb_2d_multiview(masks, hc["embed_dim"] // 2))
        ref = self.reference_points.weight
        query_pos = self.query_embedding(pos2posemb3d(ref))
        C, Q = hc["embed_dim"], hc["num_query"]
        L = N * H * W
        outs = self.transformer.decoder(torch.zeros((B, Q, C), device=dev), x.reshape(B, L, C),
                                        query_pos[None].expand(B, Q, C), pos.reshape(B, L, C),
                                        masks.reshape(B, L), noise)
        outs = torch.nan_to_num(outs)
        cls = self.cls_branches[0](outs)
        reg = self.reg_branches[0](outs)
        r = inverse_sigmoid(ref)
        xy = torch.sigmoid(reg[..., 0:2] + r[:, 0:2])
        z = torch.sigmoid(reg[..., 4:5] + r[:, 2:3])
        pc = hc["pc_range"]
        codes = torch.cat([xy[..., 0:1] * (pc[3] - pc[0]) + pc[0], xy[..., 1:2] * (pc[4] - pc[1]) + pc[1],
                           reg[..., 2:4], z * (pc[5] - pc[2]) + pc[2], reg[..., 5:]], dim=-1)
        return {"cls_logits": cls, "bbox_codes": codes}


# ------------------------------------------------------------- GridMask
def grid_mask(images, grid):
    """The reference GridMask (one integer mask for every image)."""
    apply, d, st_h, st_w = grid
    if not apply:
        return images
    H, W = images.shape[2:4]
    l = min(max(int(math.floor(d * 0.5 + 0.5)), 1), d - 1)
    hh, ww = int(1.5 * H), int(1.5 * W)

    def band(coord, canvas, off, st):
        u = coord + off - st
        return (u >= 0) & (u % d < l) & (u // d < canvas // d)

    dev = images.device
    keep = band(torch.arange(H, device=dev)[:, None], hh, (hh - H) // 2, st_h) | band(
        torch.arange(W, device=dev)[None, :], ww, (ww - W) // 2, st_w)
    return images * keep.float()[:, :, None]


def draw_train_noise(generator, image_h, num_layers, grid_mask_on, batch):
    """The port's ``draw_train_noise`` (exact GridMask) from a CPU generator."""
    grid = None
    if grid_mask_on:
        apply = bool(torch.rand((), generator=generator).item() < 0.7)
        d = int(torch.randint(2, image_h, (), generator=generator).item())
        st_h, st_w = (int(x) for x in torch.randint(0, max(d, 1), (2,), generator=generator))
        grid = (apply, d, st_h, st_w)
    flash = torch.randint(0, 2**31 - 1, (num_layers,), generator=generator).tolist()
    other = torch.randint(0, 2**62, (num_layers,), generator=generator).tolist()
    return Noise(grid, tuple(zip(flash, other)), batch)


# -------------------------------------------------------------- detector
class Detector(nn.Module):
    """Backbone -> CPFPN -> PETR head, the port's parameter names.
    ``spec`` is the configuration file's ``model`` object."""

    def __init__(self, spec):
        super().__init__()
        bb, hc = spec["backbone"], spec["head"]
        self.spec = spec
        if bb["kind"] == "vovnet":
            self.img_backbone = VoVNet(bb["spec"], bb["out_indices"])
        else:
            self.img_backbone = ResNet(int(bb["spec"][1:]), bb["out_indices"], bb["dcn_stages"])
        self.img_neck = CPFPN(self.img_backbone.channels, bb["fpn_out_channels"], bb["fpn_num_outs"])
        self.pts_bbox_head = PETRHead(hc, bb["fpn_out_channels"])

    def extract_feats(self, images):
        B, N, H, W, C = images.shape
        x = images.reshape(B * N, H, W, C).permute(0, 3, 1, 2).contiguous().float()
        f = self.img_neck(self.img_backbone(x))[self.spec["head_feat_level"]]
        return f.permute(0, 2, 3, 1).reshape(B, N, *f.shape[2:], f.shape[1])

    def forward(self, images, img2lidar, img_hw, noise=None):
        H, W = images.shape[2:4]
        if self.training and noise is not None and noise.grid is not None:
            images = grid_mask(images, noise.grid)
        return self.pts_bbox_head(self.extract_feats(images), img2lidar, img_hw, (H, W), noise)


# --------------------------------------------------------------- decode
def decode_bbox(codes):
    return torch.cat([codes[..., 0:1], codes[..., 1:2], codes[..., 4:5], codes[..., 2:3].exp(),
                      codes[..., 3:4].exp(), codes[..., 5:6].exp(), torch.atan2(codes[..., 6:7], codes[..., 7:8]),
                      codes[..., 8:10]], dim=-1)


def encode_bbox(boxes):
    yaw = boxes[..., 6:7]
    return torch.cat([boxes[..., 0:2], boxes[..., 3:5].log(), boxes[..., 2:3], boxes[..., 5:6].log(),
                      yaw.sin(), yaw.cos(), boxes[..., 7:9]], dim=-1)


def last_layer_table(outputs) -> Tuple[torch.Tensor, torch.Tensor]:
    """The last decoder layer's per-query scores (B, Q, C) and decoded boxes
    (B, Q, 9): every detection the NMS-free decode can pick from."""
    return torch.sigmoid(outputs["cls_logits"][-1].float()), decode_bbox(outputs["bbox_codes"][-1].float())


# ------------------------------------------------------- BN statistics
@torch.no_grad()
def normalize_bn_statistics(backbone: nn.Module, x: torch.Tensor) -> int:
    """Set every frozen BN's running statistics to the per-channel mean and
    (biased) variance of what reaches it in one forward of ``backbone`` on
    ``x`` (B, 3, H, W), each set just before it runs (as ``chip_smoke.py``'s
    ``normalize_bn_statistics``); returns how many it set."""

    def set_stats(module, args):
        a = args[0].float()
        module.running_mean.copy_(a.mean(dim=(0, 2, 3)))
        module.running_var.copy_(a.var(dim=(0, 2, 3), unbiased=False))

    norms = [m for m in backbone.modules() if isinstance(m, FrozenBatchNorm)]
    handles = [m.register_forward_pre_hook(set_stats) for m in norms]
    try:
        backbone(x)
    finally:
        for h in handles:
            h.remove()
    return len(norms)
