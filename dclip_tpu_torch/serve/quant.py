"""Int8 weight-only serving of the CLIP encoders (counterpart of
`dclip_tpu/serve/quant.py`).

Post-training, symmetric per-output-channel int8 quantization of every
large GEMM weight: each encoder Linear, the two projections, the token
embedding and the patch conv, taken as a GEMM over HWIO-flattened
(ph, pw, c) patch vectors. The forward dequantizes in the compute dtype
(`q.to(dtype) * scale.to(dtype)`) and multiplies with f32 accumulation
(the product rounds to the compute dtype on the way out, then continues in
f32); LayerNorm, quick_gelu and the residual stream are f32.

`quantize_clip` works in the Flax layout ([in, out] kernels, HWIO conv)
with the JAX package's numpy rule, so on bridged weights its `q` and
`scale` equal JAX's bit for bit and the tree has JAX's structure (and so
JAX's `//` keys in an exported `params.npz`). No kernel of this package
runs here: like the JAX module, which runs it outside Pallas, this path is
plain tensor ops, so `serve.export` can trace it. Attention is the module
route's plain attention (`models.clip.plain_attention`, the counterpart
of `_xla_attention`).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from dclip_tpu_torch.kernels.vit_block import patchify, quick_gelu
from dclip_tpu_torch.models.clip import plain_attention

# -- offline weight quantization (host, numpy) ---------------------------------


def _quant_w(w: np.ndarray) -> Dict[str, np.ndarray]:
    """[K, N] float -> {q: int8 [K, N], scale: f32 [N]} (per-out-channel);
    `dclip_tpu/serve/quant.py:42-47`."""
    w = np.asarray(w, np.float32)
    scale = np.maximum(np.abs(w).max(axis=0), 1e-12) / 127.0
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return {"q": q, "scale": scale.astype(np.float32)}


def quantize_clip(model_or_state_dict: Union[torch.nn.Module, Mapping[str, torch.Tensor]],
                  cfg) -> Dict[str, Any]:
    """Quantize every large Linear / conv weight of a CLIP model (or its
    HF-named state dict). Returns JAX's serving tree: quantized kernels as
    {q, scale}, biases, LayerNorms ({scale, bias}) and embeddings as f32
    numpy. Host-side, one pass."""
    sd = model_or_state_dict
    if isinstance(sd, torch.nn.Module):
        sd = sd.state_dict()
    sd = {k: v.detach().float().cpu().numpy() for k, v in sd.items()}

    def ln(prefix):
        return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}

    def qdense(prefix):
        out = {"kernel": _quant_w(sd[f"{prefix}.weight"].T)}  # [out, in] -> Flax [in, out]
        if f"{prefix}.bias" in sd:
            out["bias"] = sd[f"{prefix}.bias"]
        return out

    def qencoder(prefix, num_layers):
        layers = {}
        for i in range(num_layers):
            p = f"{prefix}.encoder.layers.{i}"
            layers[f"layers_{i}"] = {
                "layer_norm1": ln(f"{p}.layer_norm1"),
                "layer_norm2": ln(f"{p}.layer_norm2"),
                "self_attn": {k: qdense(f"{p}.self_attn.{k}")
                              for k in ("q_proj", "k_proj", "v_proj", "out_proj")},
                "mlp": {"fc1": qdense(f"{p}.mlp.fc1"), "fc2": qdense(f"{p}.mlp.fc2")},
            }
        return layers

    # OIHW [D, 3, p, p] -> HWIO, flattened to the (ph, pw, c) patch vectors
    conv = sd["vision_model.embeddings.patch_embedding.weight"].transpose(2, 3, 1, 0)
    return {
        "text_model": {
            # The largest tensor of a real CLIP; dequantized after the gather.
            "token_embedding": _quant_w(sd["text_model.embeddings.token_embedding.weight"]),
            "position_embedding": sd["text_model.embeddings.position_embedding.weight"],
            "encoder": qencoder("text_model", cfg.text.num_layers),
            "final_layer_norm": ln("text_model.final_layer_norm"),
        },
        "vision_model": {
            "patch_embedding": _quant_w(conv.reshape(-1, conv.shape[-1])),
            "class_embedding": sd["vision_model.embeddings.class_embedding"],
            "position_embedding": sd["vision_model.embeddings.position_embedding.weight"],
            "pre_layernorm": ln("vision_model.pre_layrnorm"),
            "encoder": qencoder("vision_model", cfg.vision.num_layers),
            "post_layernorm": ln("vision_model.post_layernorm"),
        },
        "text_projection": qdense("text_projection"),
        "visual_projection": qdense("visual_projection"),
    }


def to_device(tree: Mapping[str, Any], device) -> Dict[str, Any]:
    """A nested dict of arrays -> the same dict of tensors on `device`."""
    return {k: to_device(v, device) if isinstance(v, Mapping)
            else torch.as_tensor(np.asarray(v), device=device) for k, v in tree.items()}


def tree_bytes(tree: Mapping[str, Any]) -> int:
    """Bytes held by the arrays / tensors of a nested dict."""
    return sum(tree_bytes(v) if isinstance(v, Mapping)
               else v.numel() * v.element_size() if isinstance(v, torch.Tensor)
               else np.asarray(v).nbytes for v in tree.values())


# -- the weight-only int8 forward -----------------------------------------------


def _compute_dtype(device: torch.device) -> torch.dtype:
    """bf16 on the card, f32 on the CPU (`dclip_tpu/serve/quant.py:118-121`)."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def _wq_dense(x: torch.Tensor, qd: Mapping[str, Any], dtype: torch.dtype) -> torch.Tensor:
    """y = x @ dequant(q) (+ bias), f32 out."""
    w = qd["kernel"]["q"].to(dtype) * qd["kernel"]["scale"].to(dtype)
    y = torch.matmul(x.to(dtype), w).float()
    if "bias" in qd:
        y = y + qd["bias"]
    return y


def _ln(x: torch.Tensor, p: Mapping[str, torch.Tensor], eps: float) -> torch.Tensor:
    return F.layer_norm(x.float(), p["scale"].shape, p["scale"], p["bias"], eps)


def _encoder(x, layers, num_heads, eps, causal, padding_mask, dtype):
    for i in range(len(layers)):
        p = layers[f"layers_{i}"]
        h = _ln(x, p["layer_norm1"], eps)
        a = p["self_attn"]
        q, k, v = (_wq_dense(h, a[n], dtype).to(dtype) for n in ("q_proj", "k_proj", "v_proj"))
        out = plain_attention(q, k, v, num_heads, causal, padding_mask)
        x = x + _wq_dense(out, a["out_proj"], dtype)
        h = _ln(x, p["layer_norm2"], eps)
        h = quick_gelu(_wq_dense(h, p["mlp"]["fc1"], dtype))  # f32
        x = x + _wq_dense(h, p["mlp"]["fc2"], dtype)
    return x


def quantized_image_features(cfg, qparams: Mapping[str, Any], pixel_values: torch.Tensor,
                             dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Int8-weight counterpart of `CLIPModule.image_features`: NHWC
    [B, H, W, 3] CLIP-normalized pixels -> [B, P] f32."""
    dtype = dtype or _compute_dtype(pixel_values.device)
    c = cfg.vision
    v = qparams["vision_model"]
    x = _wq_dense(patchify(pixel_values.float(), c.patch_size),
                  {"kernel": v["patch_embedding"]}, dtype)
    cls = v["class_embedding"].reshape(1, 1, -1).expand(x.shape[0], 1, -1)
    x = torch.cat([cls, x], dim=1) + v["position_embedding"][None]
    x = _ln(x, v["pre_layernorm"], c.layer_norm_eps)
    x = _encoder(x, v["encoder"], c.num_heads, c.layer_norm_eps, False, None, dtype)
    pooled = _ln(x[:, 0], v["post_layernorm"], c.layer_norm_eps)
    return _wq_dense(pooled, qparams["visual_projection"], dtype)


def quantized_text_features(cfg, qparams: Mapping[str, Any], input_ids: torch.Tensor,
                            attention_mask: Optional[torch.Tensor] = None,
                            dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Int8-weight counterpart of `CLIPModule.get_text_features`: [B, T]
    ids and mask -> [B, P] f32, pooled at the first EOS id (the last
    position in a row without one)."""
    dtype = dtype or _compute_dtype(input_ids.device)
    c = cfg.text
    t = qparams["text_model"]
    b, s = input_ids.shape
    te = t["token_embedding"]
    x = te["q"][input_ids.long()].float() * te["scale"] + t["position_embedding"][None, :s]
    x = _encoder(x, t["encoder"], c.num_heads, c.layer_norm_eps, True, attention_mask, dtype)
    x = _ln(x, t["final_layer_norm"], c.layer_norm_eps)
    is_eos = (input_ids == c.eos_token_id).to(torch.int32)
    eos_idx = torch.where(is_eos.sum(-1) > 0, is_eos.argmax(-1),
                          torch.full_like(is_eos[:, 0], s - 1, dtype=torch.int64))
    pooled = x[torch.arange(b, device=x.device), eos_idx]
    return _wq_dense(pooled, qparams["text_projection"], dtype)
