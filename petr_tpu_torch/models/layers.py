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
    moments over the data group, and the cross-attentions run on this
    rank's slice of the keys (``key_shard``), on either branch.
"""

from __future__ import annotations

import contextlib
import math
import threading
import weakref
from collections import OrderedDict
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from petr_tpu_torch.ops.conv3x3 import conv3x3_bn_relu, conv_impl
from petr_tpu_torch.ops.conv_int8 import conv_int8_bn_act_tiled, conv_plan, fold_bn, prepare_operands, tile_weight
from petr_tpu_torch.ops.cross_attention import flash_cross_attention
from petr_tpu_torch.parallel.mesh import current_mesh, data_mean, data_parallel
from petr_tpu_torch.parallel.sharded_attention import (KeyShard, flash_partial_attention, partial_softmax_attention,
                                                      project_shard)


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


def lecun_normal_(weight: torch.Tensor, fan_in: Optional[int] = None) -> torch.Tensor:
    """flax's default kernel init (``lecun_normal``): a normal of variance
    1 / fan_in truncated at 2 std, its std corrected for the truncation."""
    fan_in = weight[0].numel() if fan_in is None else fan_in
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std)


def dense(in_features: int, out_features: int, bias: bool = True, kernel: str = "lecun") -> Linear:
    """A ``Linear`` drawn as a flax ``nn.Dense``: the kernel by ``kernel``
    ("lecun", flax's default; "xavier", uniform; "zeros"), the bias 0."""
    layer = Linear(in_features, out_features, bias=bias)
    with torch.no_grad():
        if kernel == "lecun":
            lecun_normal_(layer.weight)
        elif kernel == "xavier":
            nn.init.xavier_uniform_(layer.weight)
        elif kernel == "zeros":
            layer.weight.zero_()
        else:
            raise ValueError(f"kernel must be lecun|xavier|zeros, got {kernel!r}")
        if bias:
            layer.bias.zero_()
    return layer


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


QUANT_MODES = ("none", "calib", "int8")


class QuantConv2d(Conv2d):
    """The conv of a ``ConvBNReLU``, with petr_tpu's int8 PTQ state
    (`layers.py:164-174`): ``quant`` is "none", "calib" (the forward records
    the running max |x| of its input in fp32) or "int8" (the conv runs on
    int8 operands, ``ops.conv_int8``). The recorded max, ``act_amax``, is a
    non-persistent buffer registered when a mode other than "none" is first
    set: the ``state_dict``, checkpoints and the converter stay as they are,
    as petr_tpu keeps it in its own "quant" collection.

    In "int8" the weight side of the op (the BN folded in, quantised per
    output channel, packed and tiled for K6's plan) is prepared once and kept
    in a plain attribute (not a buffer: nothing of it is saved). It is
    prepared again when any of its sources (the weight, the BN's four tensors,
    ``act_amax``) is another tensor object (``load_state_dict(assign=True)``,
    a new Parameter), was updated in place (its version counter: ``copy_``,
    ``load_state_dict``, an optimizer step) or moved (device, data pointer).
    A write through ``.data`` bypasses version counters: call
    ``drop_int8_operands`` after one. Under tracing the operands are inputs of
    the program, prepared once outside it: ``serve.export`` passes them
    (``_int8_given``), and a trace without them raises."""

    quant = "none"
    _int8_cache = None  # (weakrefs to the sources, (eps, their marks), weakref to the BN, prepared, {bn: tiles})
    _int8_given = None  # ({bn: tiles}, sa, scale, add), set while serve.export traces

    def set_quant(self, mode: str) -> None:
        if mode not in QUANT_MODES:
            raise ValueError(f"quant must be one of {QUANT_MODES}, got {mode!r}")
        if mode != "none" and "act_amax" not in self._buffers:
            self.register_buffer("act_amax", torch.zeros((), device=self.weight.device), persistent=False)
        self.quant = mode
        self.drop_int8_operands()

    def drop_int8_operands(self) -> None:
        """Forget the prepared int8 operands: the next int8 forward prepares them."""
        self._int8_cache = None

    def int8_prepared(self) -> Optional[Tuple["FrozenBatchNorm", Tuple[torch.Tensor, ...], Dict[int, torch.Tensor]]]:
        """(the BN folded in, (wq, sa, scale, add), {tile width: wt}) as the
        last int8 forward prepared them, or None."""
        if self._int8_cache is None:
            return None
        _, _, norm, prepared, tiles = self._int8_cache
        return norm(), prepared, tiles

    def int8_operands(self, norm: "FrozenBatchNorm", x: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """(wt, the int8 weight tiles at the tile width of K6's plan for ``x``;
        sa; scale = sa * sw; add) of the int8 conv with ``norm`` folded in,
        prepared once per weight (see above), and laid out once per tile
        width."""
        bn = conv_plan(*x.shape, self.out_channels, self.kernel_size[0], self.stride[0]).bn
        if self._int8_given is not None:
            tiles, sa, scale, add = self._int8_given
            if bn not in tiles:
                raise ValueError(f"the traced int8 conv was given tiles of width {sorted(tiles)}, its plan takes {bn}")
            return tiles[bn], sa, scale, add
        if torch.compiler.is_compiling():
            raise RuntimeError("an int8 conv is traced on operands prepared once, outside the program "
                               "(serve.export passes them): it does not quantise its weight per call")
        sources = (self.weight, norm.weight, norm.bias, norm.running_mean, norm.running_var, self.act_amax)
        # inference tensors have no version counter: prepared on every call
        marks = None if any(t.is_inference() for t in sources) else (
            norm.eps,) + tuple((t._version, t.device, t.data_ptr()) for t in sources)
        cache = self._int8_cache
        if (cache is None or marks is None or cache[1] != marks
                or any(ref() is not t for ref, t in zip(cache[0], sources))):
            with torch.no_grad():
                mul, add = fold_bn(norm.weight, norm.bias, norm.running_mean, norm.running_var, norm.eps)
                prepared = prepare_operands(self.weight, mul, add, self.act_amax)
            if marks is None:
                return (tile_weight(prepared[0], bn),) + prepared[1:]
            cache = self._int8_cache = (tuple(weakref.ref(t) for t in sources), marks, weakref.ref(norm), prepared, {})
        prepared, tiles = cache[3], cache[4]
        if bn not in tiles:
            tiles[bn] = tile_weight(prepared[0], bn)
        return (tiles[bn],) + prepared[1:]


def conv_bn_act(conv: QuantConv2d, norm: "FrozenBatchNorm", relu: Optional[nn.Module], x: torch.Tensor,
                fused_route: bool = True) -> torch.Tensor:
    """conv (no bias) -> BN -> ReLU (if ``relu``), the forward of ``ConvBNReLU``
    and of VoVNet's stem. With ``conv.quant`` "int8" the three run as one
    int8 conv (``conv_int8_bn_act_tiled``: K6 on CUDA) on the BN folded to
    ``mul``/``add``; "calib" records max |x| first. ``fused_route``: a 3x3
    stride-1 conv may take the K5 route (``PETR_TPU_TORCH_CONV_IMPL=cuda``).
    The int8 conv's weight side is prepared once per weight
    (``QuantConv2d.int8_operands``)."""
    if conv.quant != "none":
        if norm.use_batch_stats:
            raise ValueError("int8 PTQ requires frozen BN (serving path)")
        if conv.quant == "int8":
            wt, sa, scale, add = conv.int8_operands(norm, x)
            return conv_int8_bn_act_tiled(x, wt, sa, scale, add, conv.stride[0], relu is not None)
        with torch.no_grad():
            conv.act_amax.copy_(torch.maximum(conv.act_amax, x.abs().amax().float()))
    fusable = (conv.kernel_size == (3, 3) and conv.stride == (1, 1)
               and conv.dilation == (1, 1) and conv.groups == 1)
    if fused_route and conv_impl() == "cuda" and fusable and not norm.batch_moments():
        mul = norm.weight * torch.rsqrt(norm.running_var + norm.eps)
        add = norm.bias - norm.running_mean * mul
        return conv3x3_bn_relu(x, conv.weight, mul, add, relu=relu is not None)
    y = norm(conv(x))
    return y if relu is None else relu(y)


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
    with the batch's moments (petr_tpu `layers.py:243`). ``quant`` is the
    conv's int8 PTQ mode (``QuantConv2d``), which takes precedence over
    both routes; "calib" and "int8" refuse batch-moments BN, as petr_tpu's.
    """

    def __init__(
        self, name: str, in_channels: int, out_channels: int, kernel: int = 3,
        stride: int = 1, relu: bool = True, bn_mode: str = "frozen", quant: str = "none",
    ):
        conv = QuantConv2d(in_channels, out_channels, kernel, stride, kernel // 2, bias=False)
        conv.set_quant(quant)
        layers = [
            (f"{name}/conv", conv),
            (f"{name}/norm", FrozenBatchNorm(out_channels, use_batch_stats=bn_mode == "batch")),
        ]
        if relu:
            layers.append((f"{name}/relu", nn.ReLU(inplace=True)))
        super().__init__(OrderedDict(layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_bn_act(self[0], self[1], self[2] if len(self) == 3 else None, x)


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

    ``key_shard`` (a ``KeyShard``: the first global key of ``key`` and
    ``value``, and the global key count) says they are this rank's slice of
    the keys under token sharding: the attention then runs through
    ``flash_partial_attention`` (K3 on the shard, the lse combine over the
    model group), or on the plain branch through
    ``partial_softmax_attention`` (the shared max, the sums combined), and
    the k/v projections' parameters take their gradient summed over the
    group. Under a mesh each rank drops by its slice of the global mask:
    the flash hash takes this rank's first global batch row and key, the
    plain branch draws the global mask from ``generator`` and keeps its
    slice.
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
        key_shard: Optional[KeyShard] = None,
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
            offsets = (0 if mesh is None else mesh.batch_rows(B)[1], 0 if key_shard is None else key_shard.start)
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
        elif key_shard is not None:
            out = partial_softmax_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), key_padding_mask, mesh,
                rate, generator, key_shard,
            ).transpose(1, 2)
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


def xavier_attention(embed_dim: int, num_heads: int, dropout_rate: float = 0.0) -> MultiheadAttention:
    """A plain-branch ``MultiheadAttention`` drawn as petr_tpu's
    (`layers.py:320-330,365-368`): in_proj packed-Xavier, its bias 0, out_proj
    Xavier-uniform with a zero bias."""
    attn = MultiheadAttention(embed_dim, num_heads, dropout_rate=dropout_rate)
    with torch.no_grad():
        nn.init.xavier_uniform_(attn.attn.out_proj.weight)
        attn.attn.out_proj.bias.zero_()
    return attn


def xavier_ffn(embed_dim: int, hidden_dim: int, dropout_rate: float = 0.0) -> FFN:
    """An ``FFN`` drawn as petr_tpu's with ``torch_bias=True`` (the
    per-parameter Xavier pass of DETR3D's and deformable DETR's decoders):
    Xavier-uniform weights, torch's default biases."""
    ffn = FFN(embed_dim, hidden_dim, dropout_rate)
    with torch.no_grad():
        nn.init.xavier_uniform_(ffn.layers[0][0].weight)
        nn.init.xavier_uniform_(ffn.layers[1].weight)
    return ffn
