"""Shared NN building blocks (PyTorch), counterpart of `petr_tpu/models/layers.py`.

Conventions:
  * parameters stay fp32; every layer casts them to the dtype of the
    activation it receives, and the activations enter the compute dtype at
    the same points where petr_tpu calls ``.astype(self.dtype)`` (the
    detector's input, the head's positional embeddings and queries). So a
    bf16 model computes in bf16 with fp32 parameters, as petr_tpu does.
  * convolutions run NCHW; the head's 1x1 convolutions act on channels-last
    tokens as per-pixel linear maps (``PointwiseConv2d``).
  * module and parameter names follow the reference mmdet3d checkpoint
    (`img_backbone.*`, `img_neck.*`, `pts_bbox_head.*`), so that a port
    ``state_dict`` maps onto a petr_tpu param tree through
    `petr_tpu/utils/torch_convert.py` and a released checkpoint loads as is.
  * BN is frozen by default: the reference trains and evaluates every
    shipped config with BN in eval mode, so it is one affine map per
    channel whose weight and bias may train while its running statistics
    stay buffers. ``bn_mode="batch"`` (from-scratch training) normalises
    with the batch's moments in train mode and hands them out through
    ``collect_batch_moments``; the train step folds them into the running
    statistics, never the layer itself.
  * dropout follows ``self.training``: a layer in train mode with a rate
    above 0 drops, and takes its random bits from a ``torch.Generator`` (or,
    for the flash attention, an int seed) that its caller passes in. The
    caller draws those seeds before the forward, so that a checkpointed
    layer draws the same masks again when it is recomputed.
  * under a mesh in context (``parallel.mesh.use_mesh``) a rank computes
    its share of petr_tpu's global-batch step: dropout draws the global
    batch's mask and keeps this rank's rows, batch-moments BN combines its
    moments over the data group, and the cross-attention runs on this
    rank's slice of the keys (``key_shard``).
"""

from __future__ import annotations

import contextlib
import math
import threading
from collections import OrderedDict
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from petr_tpu_torch.ops.conv3x3 import conv3x3_bn_relu, conv_impl
from petr_tpu_torch.ops.cross_attention import flash_cross_attention
from petr_tpu_torch.parallel.mesh import current_mesh, data_mean, data_parallel
from petr_tpu_torch.parallel.sharded_attention import flash_partial_attention, project_shard


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate, divide the kept
    by it; the bits come from ``generator``, on ``x``'s device. Under data
    parallelism (batch on axis 0) the generator draws the global batch's
    mask, as petr_tpu's one program does, and this rank keeps its rows."""
    if generator is None:
        raise ValueError("a dropout in train mode needs a torch.Generator from its caller")
    mesh = data_parallel()
    if mesh is None:
        keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    else:
        B, b0 = mesh.batch_rows(x.shape[0])
        keep = torch.rand((B, *x.shape[1:]), generator=generator, device=x.device)[b0:b0 + x.shape[0]] >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


class Linear(nn.Linear):
    """nn.Linear computing in the dtype of its input."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class Conv2d(nn.Conv2d):
    """nn.Conv2d (NCHW) computing in the dtype of its input."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(
            x, self.weight.to(x.dtype), bias, self.stride, self.padding,
            self.dilation, self.groups,
        )


class PointwiseConv2d(nn.Conv2d):
    """A 1x1 nn.Conv2d applied to channels-last input (..., C) as a linear map.

    Keeps the reference's conv parameter layout (O, I, 1, 1) for the head's
    ``input_proj`` / ``position_encoder`` / ``adapt_pos3d``, which petr_tpu
    computes as Dense layers on channels-last tokens.
    """

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight[:, :, 0, 0].to(x.dtype), self.bias.to(x.dtype))


class LayerNorm(nn.LayerNorm):
    """LayerNorm with flax's eps (1e-6), statistics in fp32, output in the input dtype."""

    def __init__(self, normalized_shape: int, eps: float = 1e-6):
        super().__init__(normalized_shape, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x.float(), self.normalized_shape, self.weight, self.bias, self.eps
        ).to(x.dtype)


Moments = Dict[nn.Module, Tuple[torch.Tensor, torch.Tensor]]
_LOCAL = threading.local()  # each thread's stack of open collect_batch_moments blocks


def _moment_sinks() -> List[Moments]:
    if not hasattr(_LOCAL, "sinks"):
        _LOCAL.sinks = []
    return _LOCAL.sinks


@contextlib.contextmanager
def collect_batch_moments() -> Iterator[Moments]:
    """Collect the batch moments of every batch-mode ``FrozenBatchNorm``
    that runs inside the block: yields a dict module -> (mean, Bessel-
    corrected variance), detached fp32 (C,) tensors, from this thread's
    forwards. A module keeps its first forward's moments, so a
    checkpointed region that is recomputed in the backward adds nothing.
    petr_tpu's "batch_stats" collection."""
    sink: Moments = {}
    sinks = _moment_sinks()
    sinks.append(sink)
    try:
        yield sink
    finally:
        sinks.remove(sink)


class FrozenBatchNorm(nn.Module):
    """BatchNorm with frozen running statistics, folded to one mul/add.

    Holds ``weight``/``bias`` and the ``running_mean``/``running_var``
    buffers of nn.BatchNorm2d, so a reference checkpoint loads as is (its
    ``num_batches_tracked`` is dropped).

    With ``use_batch_stats`` (``bn_mode="batch"``) a module in train mode
    normalises with the current batch's biased moments over (B, H, W) in
    fp32, and hands the mean and the unbiased variance (torch's
    ``running_var`` semantics) to the innermost ``collect_batch_moments``
    block; its buffers stay as they are (petr_tpu `layers.py:94-123`). In
    eval mode it reads the running statistics, as petr_tpu's
    ``eval_model_config`` does. Under data parallelism the moments are the
    global batch's, as petr_tpu's one program over the global batch takes
    them: each rank's are combined over the data group by the
    parallel-variance identity (equal shards), differentiably.
    """

    def __init__(self, num_features: int, eps: float = 1e-5, use_batch_stats: bool = False):
        super().__init__()
        self.eps = eps
        self.use_batch_stats = use_batch_stats
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + "num_batches_tracked", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def batch_moments(self) -> bool:
        """Whether this forward normalises with the batch's moments."""
        return self.use_batch_stats and self.training

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, C, H, W)
        if self.batch_moments():
            xf = x.float()
            mean = xf.mean(dim=(0, 2, 3))
            var = xf.var(dim=(0, 2, 3), unbiased=False)
            n = x.numel() // x.shape[1]
            mesh = data_parallel()
            if mesh is not None:
                # mean = avg(mean_i); var = avg(var_i + (mean_i - mean)^2)
                local_mean, mean = mean, data_mean(mean, mesh)
                var = data_mean(var + (local_mean - mean) ** 2, mesh)
                n *= mesh.data
            sinks = _moment_sinks()
            if sinks:
                sinks[-1].setdefault(self, (mean.detach(), (var * (n / max(n - 1, 1))).detach()))
        else:
            mean, var = self.running_mean, self.running_var
        mul = self.weight * torch.rsqrt(var + self.eps)
        add = self.bias - mean * mul
        return x * mul.to(x.dtype)[:, None, None] + add.to(x.dtype)[:, None, None]


class ConvBNReLU(nn.Sequential):
    """conv (no bias) + BN + optional ReLU, the backbone workhorse.

    Children are named ``{name}/conv``, ``{name}/norm``, ``{name}/relu`` as in
    the reference VoVNet's ``conv3x3``/``conv1x1`` helpers.

    With ``PETR_TPU_TORCH_CONV_IMPL=cuda`` a 3x3 stride-1 conv takes the
    fused route, ``conv3x3_bn_relu`` (K5 on CUDA), with the weight taken in
    the compute dtype (the kernel's wrapper casts it in the copy that
    repacks it) and the BN folded to an fp32 ``mul``/``add``, as petr_tpu's
    ``PETR_TPU_CONV_IMPL=pallas`` does (`layers.py:243-252`). The default,
    ``cudnn``, runs the children in turn, and so does a BN that normalises
    with the batch's moments (petr_tpu `layers.py:243`).
    """

    def __init__(
        self, name: str, in_channels: int, out_channels: int, kernel: int = 3,
        stride: int = 1, relu: bool = True, bn_mode: str = "frozen",
    ):
        layers = [
            (f"{name}/conv", Conv2d(in_channels, out_channels, kernel, stride, kernel // 2, bias=False)),
            (f"{name}/norm", FrozenBatchNorm(out_channels, use_batch_stats=bn_mode == "batch")),
        ]
        if relu:
            layers.append((f"{name}/relu", nn.ReLU(inplace=True)))
        super().__init__(OrderedDict(layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv, norm = self[0], self[1]
        fusable = (conv.kernel_size == (3, 3) and conv.stride == (1, 1)
                   and conv.dilation == (1, 1) and conv.groups == 1)
        if conv_impl() == "cuda" and fusable and not norm.batch_moments():
            mul = norm.weight * torch.rsqrt(norm.running_var + norm.eps)
            add = norm.bias - norm.running_mean * mul
            return conv3x3_bn_relu(x, conv.weight, mul, add, relu=len(self) == 3)
        return super().forward(x)


class MLP(nn.Sequential):
    """Linear stack with ReLU between layers (no final activation).

    ``pointwise=True`` makes each layer a 1x1 conv acting on channels-last
    input (the reference's conv-MLPs); either way the children are indexed
    0, 2, 4, ... as in the reference's nn.Sequential.
    """

    def __init__(self, in_features: int, features: Sequence[int], pointwise: bool = False):
        layers = []
        for i, f in enumerate(features):
            layers.append(PointwiseConv2d(in_features, f) if pointwise else Linear(in_features, f))
            if i < len(features) - 1:
                layers.append(nn.ReLU())
            in_features = f
        super().__init__(*layers)


class SELayer(nn.Module):
    """PETRv2's feature-guided PE gate (`petr_tpu/models/layers.py:400-420`,
    reference `petrv2_head.py:48-60`): x * sigmoid(conv_expand(relu(
    conv_reduce(gate_input)))), the two 1x1 convs acting on channels-last
    input (``PointwiseConv2d``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv_reduce = PointwiseConv2d(channels, channels)
        self.conv_expand = PointwiseConv2d(channels, channels)

    def forward(self, x: torch.Tensor, gate_input: torch.Tensor) -> torch.Tensor:
        gate = self.conv_expand(torch.relu(self.conv_reduce(gate_input)))
        return x * torch.sigmoid(gate)


class FFN(nn.Module):
    """Transformer feed-forward block (no residual; the caller adds it).

    mmcv FFN layout: ``layers.0.0`` and ``layers.1`` are the two Linears.
    In train mode, dropout after the ReLU and after the second Linear
    (`petr_tpu/models/layers.py:391,396`).
    """

    def __init__(self, embed_dim: int, hidden_dim: int, dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.layers = nn.Sequential(
            nn.Sequential(Linear(embed_dim, hidden_dim), nn.ReLU()),
            Linear(hidden_dim, embed_dim),
        )

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = self.layers[0](x)
        drop = self.training and self.dropout_rate > 0.0
        if drop:
            y = dropout(y, self.dropout_rate, generator)
        y = self.layers[1](y)
        if drop:
            y = dropout(y, self.dropout_rate, generator)
        return y


class AttentionProjections(nn.Module):
    """The parameters of torch's nn.MultiheadAttention: packed q/k/v
    ``in_proj_weight`` (3C, C) and ``in_proj_bias`` (3C,), and ``out_proj``."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = Linear(embed_dim, embed_dim)
        nn.init.xavier_uniform_(self.in_proj_weight)


class MultiheadAttention(nn.Module):
    """Batch-first multi-head attention, the reference's mmcv wrapper around
    nn.MultiheadAttention (`petr_transformer.py:227-367`): the caller adds
    the positional embeddings to query/key and the residual to the output.

    ``use_flash`` routes the attention itself to ``flash_cross_attention``
    (K1 forward and K2 backward on CUDA), which drops the probabilities in
    the kernel by a hash of ``flash_seed``; otherwise it is the plain branch
    of petr_tpu (`layers.py:353-361`): fp32 logits, finfo.min masking,
    softmax, and dropout of the probabilities drawn from ``generator``.
    Dropout acts in train mode only.

    ``key_shard`` (the first global key of ``key`` and ``value``) says they
    are this rank's slice of the keys under token sharding: the attention
    then runs through ``flash_partial_attention`` (K3 on the shard, the lse
    combine over the model group), and the k/v projections' parameters take
    their gradient summed over the group. Under a mesh the flash hash takes
    this rank's first global batch row and key, so each rank drops by its
    slice of the global mask.
    """

    def __init__(self, embed_dim: int, num_heads: int, use_flash: bool = False,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.use_flash = use_flash
        self.dropout_rate = dropout_rate
        self.attn = AttentionProjections(embed_dim)

    def forward(
        self,
        query: torch.Tensor,  # (B, Q, C)
        key: torch.Tensor,  # (B, L, C)
        value: torch.Tensor,  # (B, L, C)
        key_padding_mask: Optional[torch.Tensor] = None,  # (B, L) True = pad
        flash_seed: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        key_shard: Optional[int] = None,
    ) -> torch.Tensor:
        C, H = self.embed_dim, self.num_heads
        rate = self.dropout_rate if self.training else 0.0
        D = C // H
        w = self.attn.in_proj_weight.to(query.dtype)
        b = self.attn.in_proj_bias.to(query.dtype)
        q = F.linear(query, w[:C], b[:C])
        mesh = current_mesh()
        if key_shard is None:
            k = F.linear(key, w[C:2 * C], b[C:2 * C])
            v = F.linear(value, w[2 * C:], b[2 * C:])
        else:
            if not self.use_flash:
                raise NotImplementedError("token-sharded attention runs the flash route only (use_flash=True)")
            pw, pb = self.attn.in_proj_weight, self.attn.in_proj_bias
            k = project_shard(key, pw[C:2 * C], pb[C:2 * C], mesh)
            v = project_shard(value, pw[2 * C:], pb[2 * C:], mesh)
        B, Q, _ = q.shape
        L = k.shape[1]
        q = q.view(B, Q, H, D)
        k = k.view(B, L, H, D)
        v = v.view(B, L, H, D)
        if self.use_flash:
            if rate > 0.0 and flash_seed is None:
                raise ValueError("flash attention dropout in train mode needs a flash_seed")
            seed = flash_seed if rate > 0.0 else None
            offsets = (0 if mesh is None else mesh.batch_rows(B)[1], key_shard or 0)
            if key_shard is None:
                out, _ = flash_cross_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), key_padding_mask,
                    rate, seed, offsets,
                )
            else:
                out = flash_partial_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), key_padding_mask, mesh,
                    rate, seed, offsets,
                )
            out = out.transpose(1, 2)
        else:
            scale = 1.0 / math.sqrt(D)
            logits = torch.einsum("bqhd,blhd->bhql", q, k).float() * scale
            if key_padding_mask is not None:
                logits = logits.masked_fill(
                    key_padding_mask[:, None, None, :], torch.finfo(torch.float32).min
                )
            attn = logits.softmax(-1)
            if rate > 0.0:
                attn = dropout(attn, rate, generator)
            out = torch.einsum("bhql,blhd->bqhd", attn.to(q.dtype), v)
        return self.attn.out_proj(out.reshape(B, Q, C))
