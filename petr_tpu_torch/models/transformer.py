"""PETR decoder-only DETR transformer (PyTorch, batch-first).

Counterpart of `petr_tpu/models/transformer.py` (reference
`models/utils/petr_transformer.py`, sty61010/PETR): post-norm decoder layers
with op order self_attn -> norm -> cross_attn -> norm -> ffn -> norm; a
shared post-LN on every intermediate output while the raw query feeds the
next layer; zero query target; additive query/key positional embeddings.
Module names follow mmcv's ``PETRTransformerDecoderLayer``
(``attentions.{0,1}.attn``, ``ffns.0``, ``norms.{0,1,2}``).

In train mode a layer drops at five places (the self-attention
probabilities, ``drop_sa``, the cross-attention probabilities, ``drop_ca``
and the FFN's two), from two seeds its caller draws before the forward: an
int32 seed for the flash kernels' hash and one for a ``torch.Generator``
that draws the others in a fixed order. With ``remat`` each layer is a
``torch.utils.checkpoint`` region (`petr_tpu/models/transformer.py:165`),
and its recompute draws the same masks again from the same seeds.

Under token sharding (a mesh in context with a model axis above 1) the
transformer cuts the N*H*W memory tokens, their positional embeddings and
their padding mask to this rank's contiguous slice (`petr_tpu/models/
transformer.py:209-215`), a short last shard padded and masked, and each
layer's cross-attention attends over that slice (``key_shard``); the
queries stay replicated.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from petr_tpu_torch.models.layers import FFN, LayerNorm, MultiheadAttention, dropout
from petr_tpu_torch.parallel.mesh import token_parallel
from petr_tpu_torch.parallel.sharded_attention import scatter_mask_to_model, scatter_to_model

# (flash seed, dropout seed) of one decoder layer's training forward
LayerSeeds = Tuple[int, int]


def layer_noise(layer: nn.Module, seeds: Optional[LayerSeeds], device: torch.device
                ) -> Tuple[float, Optional[int], Optional[torch.Generator]]:
    """A decoder layer's dropout rate in its mode, its flash seed, and a
    ``torch.Generator`` on ``device`` seeded for the layer's other drops
    (None, None at rate 0)."""
    rate = layer.dropout_rate if layer.training else 0.0
    if rate == 0.0:
        return rate, None, None
    if seeds is None:
        raise ValueError("a decoder layer in train mode with dropout needs its seeds")
    gen = torch.Generator(device=device)
    gen.manual_seed(seeds[1])
    return rate, seeds[0], gen


class PETRDecoderLayer(nn.Module):
    """One post-norm decoder layer: self-attn, cross-attn, FFN."""

    def __init__(self, embed_dim: int = 256, num_heads: int = 8, ffn_dim: int = 2048,
                 use_flash: bool = False, dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.attentions = nn.ModuleList([
            MultiheadAttention(embed_dim, num_heads, dropout_rate=dropout_rate),
            MultiheadAttention(embed_dim, num_heads, use_flash=use_flash, dropout_rate=dropout_rate),
        ])
        self.ffns = nn.ModuleList([FFN(embed_dim, ffn_dim, dropout_rate)])
        self.norms = nn.ModuleList(LayerNorm(embed_dim) for _ in range(3))

    def forward(
        self,
        query: torch.Tensor,  # (B, Q, C)
        memory: torch.Tensor,  # (B, L, C)
        query_pos: torch.Tensor,  # (B, Q, C)
        key_pos: torch.Tensor,  # (B, L, C)
        key_padding_mask: Optional[torch.Tensor],  # (B, L) True = pad
        seeds: Optional[LayerSeeds] = None,
        key_shard: Optional[int] = None,  # memory is this rank's keys from this global key on
    ) -> torch.Tensor:
        rate, flash_seed, gen = layer_noise(self, seeds, query.device)
        q_in = query + query_pos
        sa = self.attentions[0](q_in, q_in, query, generator=gen)
        if rate > 0.0:
            sa = dropout(sa, rate, gen)  # drop_sa
        query = self.norms[0](query + sa)
        ca = self.attentions[1](
            query + query_pos, memory + key_pos, memory, key_padding_mask=key_padding_mask,
            flash_seed=flash_seed, generator=gen, key_shard=key_shard,
        )
        if rate > 0.0:
            ca = dropout(ca, rate, gen)  # drop_ca
        query = self.norms[1](query + ca)
        return self.norms[2](query + self.ffns[0](query, generator=gen))


class PETRTransformerDecoder(nn.Module):
    """Stack of decoder layers returning all intermediate outputs (L, B, Q, C).

    ``make_layer`` builds each layer (default: ``PETRDecoderLayer``); the
    Depthr head's layers also take the depth tokens, ``depth``."""

    def __init__(self, num_layers: int = 6, embed_dim: int = 256, num_heads: int = 8,
                 ffn_dim: int = 2048, use_flash: bool = False, dropout_rate: float = 0.0,
                 remat: bool = False, make_layer: Optional[Callable[[], nn.Module]] = None):
        super().__init__()
        self.remat = remat
        if make_layer is None:
            def make_layer():
                return PETRDecoderLayer(embed_dim, num_heads, ffn_dim, use_flash, dropout_rate)
        self.layers = nn.ModuleList(make_layer() for _ in range(num_layers))
        self.post_norm = LayerNorm(embed_dim)

    def forward(self, query, memory, query_pos, key_pos, key_padding_mask=None,
                layer_seeds: Optional[Sequence[LayerSeeds]] = None, depth: Optional[torch.Tensor] = None,
                key_shard: Optional[int] = None):
        remat = self.remat and self.training and torch.is_grad_enabled()
        outs = []
        kwargs = {} if key_shard is None else {"key_shard": key_shard}
        for i, layer in enumerate(self.layers):
            seeds = None if layer_seeds is None else tuple(layer_seeds[i])
            args = (query, memory, query_pos, key_pos, key_padding_mask, seeds)
            if depth is not None:
                args += (depth,)
            query = checkpoint(layer, *args, use_reentrant=False, **kwargs) if remat else layer(*args, **kwargs)
            outs.append(self.post_norm(query))
        return torch.stack(outs, dim=0)


class PETRTransformer(nn.Module):
    """Flatten multi-view features to tokens and run the decoder.

    Memory tokens are (B, N*H*W, C) in (view, row, column) order; returns
    the (num_layers, B, Q, C) stack.
    """

    def __init__(self, num_layers: int = 6, embed_dim: int = 256, num_heads: int = 8,
                 ffn_dim: int = 2048, use_flash: bool = False,
                 dtype: torch.dtype = torch.float32, dropout_rate: float = 0.0,
                 remat: bool = False, make_layer: Optional[Callable[[], nn.Module]] = None):
        super().__init__()
        self.dtype = dtype
        self.custom_layers = make_layer is not None
        self.decoder = PETRTransformerDecoder(
            num_layers, embed_dim, num_heads, ffn_dim, use_flash, dropout_rate, remat, make_layer
        )

    def forward(
        self,
        feats: torch.Tensor,  # (B, N, H, W, C)
        masks: torch.Tensor,  # (B, N, H, W) True = pad
        query_embed: torch.Tensor,  # (Q, C)
        pos_embed: torch.Tensor,  # (B, N, H, W, C)
        layer_seeds: Optional[Sequence[LayerSeeds]] = None,
        depth: Optional[torch.Tensor] = None,  # (B, N, H, W, C) Depthr's depth tokens
    ) -> torch.Tensor:
        B, N, H, W, C = feats.shape
        memory = feats.reshape(B, N * H * W, C)
        key_pos = pos_embed.reshape(B, N * H * W, C).to(self.dtype)
        key_padding_mask = masks.reshape(B, N * H * W)
        Q = query_embed.shape[0]
        query_pos = query_embed[None].expand(B, Q, C).to(self.dtype)
        target = torch.zeros((B, Q, C), dtype=self.dtype, device=feats.device)
        if depth is not None:
            depth = depth.reshape(B, N * H * W, C).to(self.dtype)
        mesh, key_shard = token_parallel(), None
        if mesh is not None:
            if self.custom_layers:
                raise NotImplementedError("token sharding runs PETRDecoderLayer only")
            L = N * H * W
            memory, key_shard = scatter_to_model(memory, mesh)
            key_pos, _ = scatter_to_model(key_pos, mesh)
            key_padding_mask = scatter_mask_to_model(key_padding_mask, L, mesh, B, feats.device)
        return self.decoder(target, memory, query_pos, key_pos, key_padding_mask, layer_seeds, depth, key_shard)
