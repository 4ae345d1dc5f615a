"""CLIP text encoder (ViT-L/14 text tower): the frozen prompt encoder.

Counterpart of ``gmdx/models/clip_text.py``: a 77-token causal transformer
with quick-GELU and a final LayerNorm; ``clip_skip`` runs fewer layers and
re-applies the final LN. The module tree is transformers' ``CLIPTextModel``
(``text_model.encoder.layers.0.self_attn.q_proj``, ...), so its state dicts
load with ``strict=True``. 77 tokens are tiny: attention is a plain einsum
with an fp32 softmax, as in the JAX package. ``dtype`` is the compute dtype,
as in the UNet; the hidden states come out in fp32.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from gmdx_torch.models.layers import layer_norm, linear


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5


CLIP_VIT_L_CONFIG = CLIPTextConfig()
TINY_CLIP_CONFIG = CLIPTextConfig(
    vocab_size=1000, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64
)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class _Attention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.heads = cfg.num_heads
        self.q_proj = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.k_proj = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.v_proj = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.out_proj = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor, causal: torch.Tensor) -> torch.Tensor:
        b, s, c = x.shape
        d = c // self.heads

        def heads(t):
            return t.reshape(b, s, self.heads, d)

        q, k, v = (heads(linear(x, p)) for p in (self.q_proj, self.k_proj, self.v_proj))
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * d**-0.5
        logits = logits.masked_fill(~causal, -1e9)
        w = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, s, c)
        return linear(out, self.out_proj)


class _MLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(quick_gelu(linear(x, self.fc1)), self.fc2)


class _EncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.self_attn = _Attention(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = _MLP(cfg)

    def forward(self, x: torch.Tensor, causal: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(layer_norm(x, self.layer_norm1), causal)
        return x + self.mlp(layer_norm(x, self.layer_norm2))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([_EncoderLayer(cfg) for _ in range(cfg.num_layers)])


class _TextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class CLIPTextModel(nn.Module):
    def __init__(self, config: CLIPTextConfig = CLIP_VIT_L_CONFIG,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.config = config
        self.compute_dtype = dtype
        self.text_model = _TextTransformer(config)

    def forward(self, input_ids: torch.Tensor, clip_skip: int | None = None) -> torch.Tensor:
        """(B, S) token ids -> the (B, S, hidden) fp32 states the UNet
        cross-attends to: the final LN of the last layer's output, or with
        ``clip_skip`` of the output ``clip_skip`` layers before it."""
        tm = self.text_model
        dtype = self.compute_dtype or tm.final_layer_norm.weight.dtype
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)
        x = (tm.embeddings.token_embedding(input_ids).to(dtype)
             + tm.embeddings.position_embedding(pos)[None].to(dtype))
        causal = torch.ones(s, s, dtype=torch.bool, device=input_ids.device).tril()
        # diffusers' clip_skip: hidden_states[-(clip_skip + 2)], i.e. run
        # num_layers - clip_skip - 1 layers, then the final LN.
        n_run = self.config.num_layers if clip_skip is None else self.config.num_layers - clip_skip - 1
        for layer in tm.encoder.layers[:n_run]:
            x = layer(x, causal)
        return layer_norm(x, tm.final_layer_norm).float()


__all__ = [
    "CLIPTextModel",
    "CLIPTextConfig",
    "CLIP_VIT_L_CONFIG",
    "TINY_CLIP_CONFIG",
    "quick_gelu",
]
