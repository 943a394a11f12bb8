"""BERT encoder (counterpart of `dclip_tpu/models/bert.py`): HF
`BertModel`'s post-LN architecture under HF `BertModel`'s parameter names.

embeddings = word + position + token type -> LayerNorm (eps 1e-12); each
layer = self-attention -> dense -> add & LayerNorm -> dense + exact-erf
GELU -> dense -> add & LayerNorm; pooler = tanh(dense(CLS)). The key
padding mask is additive, `finfo(float32).min` at padded keys; the logits
are f32 products of the module-dtype q and k, softmax in f32, and the
probabilities are cast back to the module dtype before they weight v, as
the JAX module's einsum with `preferred_element_type=float32` does. The
JAX module has no Pallas kernel, so neither has this one: plain tensor
ops, on any device.

Weights: the module's state dict has HF `BertModel`'s keys, so a
`transformers` state dict loads strict after `convert_bert_state_dict`
(which drops a `bert.` prefix, the pretraining heads and the
`position_ids` buffers); `load_bert_pretrained` reads a local snapshot
directory, `model.safetensors` or `pytorch_model.bin`;
`models.weights.bert_state_dict_from_jax` carries the JAX module's params
across. `bert_to_clip_features` feeds the pooled output to
`models.projections.TextProjectionModule`: the BERT -> CLIP-space branch.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    max_length: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12

    @staticmethod
    def base_uncased() -> "BertConfig":
        return BertConfig()

    @staticmethod
    def tiny_test() -> "BertConfig":
        return BertConfig(
            vocab_size=200, hidden_size=32, num_layers=2, num_heads=4,
            mlp_dim=64, max_length=16,
        )


class _LayerNorm(nn.LayerNorm):
    """LayerNorm computed in f32 and returned in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


class _Dense(nn.Module):
    """HF's `dense` (+ optional `LayerNorm`) sub-block names."""

    def __init__(self, cin: int, cout: int, eps: Optional[float], dtype, device):
        super().__init__()
        self.dense = nn.Linear(cin, cout, dtype=dtype, device=device)
        if eps is not None:
            self.LayerNorm = _LayerNorm(cout, eps=eps, dtype=dtype, device=device)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, dtype, device):
        super().__init__()
        h = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.query = nn.Linear(h, h, dtype=dtype, device=device)
        self.key = nn.Linear(h, h, dtype=dtype, device=device)
        self.value = nn.Linear(h, h, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        b, s, d = x.shape
        head_dim = d // self.num_heads

        def split(t):
            return t.reshape(b, s, self.num_heads, head_dim).transpose(1, 2)

        q, k, v = split(self.query(x)), split(self.key(x)), split(self.value(x))
        logits = torch.matmul((q * head_dim ** -0.5).float(), k.float().transpose(-1, -2))
        if mask is not None:
            logits = logits + mask
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        return torch.matmul(probs, v).transpose(1, 2).reshape(b, s, d)


class BertAttention(nn.Module):
    def __init__(self, cfg: BertConfig, dtype, device):
        super().__init__()
        self.self = BertSelfAttention(cfg, dtype, device)
        self.output = _Dense(cfg.hidden_size, cfg.hidden_size, cfg.layer_norm_eps, dtype, device)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, dtype, device):
        super().__init__()
        self.attention = BertAttention(cfg, dtype, device)
        self.intermediate = _Dense(cfg.hidden_size, cfg.mlp_dim, None, dtype, device)
        self.output = _Dense(cfg.mlp_dim, cfg.hidden_size, cfg.layer_norm_eps, dtype, device)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        attn = self.attention.output
        x = attn.LayerNorm(x + attn.dense(self.attention.self(x, mask)))
        h = F.gelu(self.intermediate.dense(x))  # exact erf GELU
        return self.output.LayerNorm(x + self.output.dense(h))


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig, dtype, device):
        super().__init__()
        h = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, h, dtype=dtype, device=device)
        self.position_embeddings = nn.Embedding(cfg.max_length, h, dtype=dtype, device=device)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, h, dtype=dtype,
                                                  device=device)
        self.LayerNorm = _LayerNorm(h, eps=cfg.layer_norm_eps, dtype=dtype, device=device)

    def forward(self, input_ids: torch.Tensor, token_type_ids: torch.Tensor) -> torch.Tensor:
        s = input_ids.shape[1]
        x = (self.word_embeddings(input_ids) + self.position_embeddings.weight[None, :s]
             + self.token_type_embeddings(token_type_ids))
        return self.LayerNorm(x)


class BertStack(nn.Module):
    def __init__(self, cfg: BertConfig, dtype, device):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg, dtype, device) for _ in range(cfg.num_layers))


class BertEncoder(nn.Module):
    """HF `BertModel`'s twin: (last_hidden_state [B, S, H], pooled [B, H])."""

    def __init__(self, cfg: BertConfig, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg, dtype, device)
        self.encoder = BertStack(cfg, dtype, device)
        self.pooler = _Dense(cfg.hidden_size, cfg.hidden_size, None, dtype, device)

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        input_ids = input_ids.long()
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = self.embeddings(input_ids, token_type_ids.long())
        mask = None
        if attention_mask is not None:
            neg = torch.finfo(torch.float32).min
            mask = torch.where(attention_mask[:, None, None, :] > 0,
                               torch.zeros((), device=x.device),
                               torch.full((), neg, device=x.device))
        for layer in self.encoder.layer:
            x = layer(x, mask)
        pooled = torch.tanh(self.pooler.dense(x[:, 0]))
        return x, pooled


# -- weights --------------------------------------------------------------------------


def convert_bert_state_dict(sd: Mapping[str, Any], cfg: BertConfig) -> Dict[str, torch.Tensor]:
    """A `transformers` `BertModel` (or `BertFor*`) state dict -> this
    module's, f32 CPU tensors: keys with a `bert.` prefix keep only those
    (dropping the pretraining heads), the `position_ids` / `token_type_ids`
    buffers of older checkpoints are dropped, and every key the module has
    must be there (`cfg.num_layers` layers)."""
    if any(k.startswith("bert.") for k in sd):
        sd = {k[len("bert."):]: v for k, v in sd.items() if k.startswith("bert.")}
    want = BertEncoder(cfg, device="meta").state_dict()
    missing = sorted(set(want) - set(sd))
    if missing:
        raise KeyError(f"not a BertModel state dict with {cfg.num_layers} layers: missing "
                       f"{missing[:4]}{' ...' if len(missing) > 4 else ''}")
    return {k: torch.as_tensor(sd[k]).detach().to("cpu", torch.float32) for k in want}


def load_bert_pretrained(path_or_dir: str, cfg: BertConfig) -> Dict[str, torch.Tensor]:
    """A local HF snapshot directory, `model.safetensors` or
    `pytorch_model.bin` (read with `weights_only=True`) -> this module's
    state dict. No network path exists."""
    from dclip_tpu_torch.models.weights import load_state_dict_file

    return convert_bert_state_dict(load_state_dict_file(path_or_dir), cfg)


def bert_to_clip_features(bert: BertEncoder, projection, input_ids: torch.Tensor,
                          attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """BERT's pooled output -> the CLIP space through `projection` (a
    `models.projections.TextProjectionModule`, or any callable on [B, H])."""
    _, pooled = bert(input_ids, attention_mask)
    return projection(pooled)
