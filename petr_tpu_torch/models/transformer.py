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
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from petr_tpu_torch.models.layers import FFN, LayerNorm, MultiheadAttention, dropout

# (flash seed, dropout seed) of one decoder layer's training forward
LayerSeeds = Tuple[int, int]


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
    ) -> torch.Tensor:
        rate = self.dropout_rate if self.training else 0.0
        flash_seed, gen = None, None
        if rate > 0.0:
            if seeds is None:
                raise ValueError("a decoder layer in train mode with dropout needs its seeds")
            flash_seed = seeds[0]
            gen = torch.Generator(device=query.device)
            gen.manual_seed(seeds[1])
        q_in = query + query_pos
        sa = self.attentions[0](q_in, q_in, query, generator=gen)
        if rate > 0.0:
            sa = dropout(sa, rate, gen)  # drop_sa
        query = self.norms[0](query + sa)
        ca = self.attentions[1](
            query + query_pos, memory + key_pos, memory, key_padding_mask=key_padding_mask,
            flash_seed=flash_seed, generator=gen,
        )
        if rate > 0.0:
            ca = dropout(ca, rate, gen)  # drop_ca
        query = self.norms[1](query + ca)
        return self.norms[2](query + self.ffns[0](query, generator=gen))


class PETRTransformerDecoder(nn.Module):
    """Stack of decoder layers returning all intermediate outputs (L, B, Q, C)."""

    def __init__(self, num_layers: int = 6, embed_dim: int = 256, num_heads: int = 8,
                 ffn_dim: int = 2048, use_flash: bool = False, dropout_rate: float = 0.0,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        self.layers = nn.ModuleList(
            PETRDecoderLayer(embed_dim, num_heads, ffn_dim, use_flash, dropout_rate)
            for _ in range(num_layers)
        )
        self.post_norm = LayerNorm(embed_dim)

    def forward(self, query, memory, query_pos, key_pos, key_padding_mask=None,
                layer_seeds: Optional[Sequence[LayerSeeds]] = None):
        remat = self.remat and self.training and torch.is_grad_enabled()
        outs = []
        for i, layer in enumerate(self.layers):
            seeds = None if layer_seeds is None else tuple(layer_seeds[i])
            args = (query, memory, query_pos, key_pos, key_padding_mask, seeds)
            query = checkpoint(layer, *args, use_reentrant=False) if remat else layer(*args)
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
                 remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.decoder = PETRTransformerDecoder(
            num_layers, embed_dim, num_heads, ffn_dim, use_flash, dropout_rate, remat
        )

    def forward(
        self,
        feats: torch.Tensor,  # (B, N, H, W, C)
        masks: torch.Tensor,  # (B, N, H, W) True = pad
        query_embed: torch.Tensor,  # (Q, C)
        pos_embed: torch.Tensor,  # (B, N, H, W, C)
        layer_seeds: Optional[Sequence[LayerSeeds]] = None,
    ) -> torch.Tensor:
        B, N, H, W, C = feats.shape
        memory = feats.reshape(B, N * H * W, C)
        key_pos = pos_embed.reshape(B, N * H * W, C).to(self.dtype)
        key_padding_mask = masks.reshape(B, N * H * W)
        Q = query_embed.shape[0]
        query_pos = query_embed[None].expand(B, Q, C).to(self.dtype)
        target = torch.zeros((B, Q, C), dtype=self.dtype, device=feats.device)
        return self.decoder(target, memory, query_pos, key_pos, key_padding_mask, layer_seeds)
