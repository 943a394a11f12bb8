"""Export the port's `CLIPModule` weights as a HuggingFace CLIP snapshot
(counterpart of `dclip_tpu/models/hf_export.py`).

The port's parameters already carry HF `CLIPModel` names and layouts
(`models/weights.py`), so the state dict goes out as it is. Writes:
  model.safetensors         weights, HF `CLIPModel` key names / layouts
  config.json               transformers `CLIPConfig` (model_type "clip")
  preprocessor_config.json  CLIP image preprocessing contract

`logit_scale` is written 0-d, the shape HF's `CLIPModel` has. The JAX
exporter writes it with shape (1,) (its `np.ascontiguousarray` lifts the
0-d array), which `load_state_dict` also accepts.

The safetensors format is written and read here with numpy alone (an
8-byte little-endian header length, a JSON header of dtype, shape and
byte offsets per tensor, then the raw bytes), so neither needs the
`safetensors` package.
"""
from __future__ import annotations

import json
import os
import shutil
import struct
from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

from dclip_tpu_torch.core.config import CLIPConfig

# HF CLIPImageProcessor constants (the values the input pipeline uses).
CLIP_IMAGE_MEAN = [0.48145466, 0.4578275, 0.40821073]
CLIP_IMAGE_STD = [0.26862954, 0.26130258, 0.27577711]

_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16, "I64": np.int64,
           "I32": np.int32, "I16": np.int16, "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_}
_NAMES = {np.dtype(v): k for k, v in _DTYPES.items()}


def save_safetensors(path: str, tensors: Mapping[str, np.ndarray],
                     metadata: Optional[Dict[str, str]] = None) -> int:
    """Write numpy arrays as a safetensors file; returns bytes written."""
    header: Dict[str, Any] = {"__metadata__": dict(metadata)} if metadata else {}
    arrays, offset = [], 0
    for name in sorted(tensors):
        a = np.asarray(tensors[name])
        a = np.ascontiguousarray(a).reshape(a.shape)  # keeps a 0-d array 0-d
        if a.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {a.dtype} has no safetensors name here")
        a = a.astype(a.dtype.newbyteorder("<"), copy=False)
        header[name] = {"dtype": _NAMES[a.dtype], "shape": list(a.shape),
                        "data_offsets": [offset, offset + a.nbytes]}
        arrays.append(a)
        offset += a.nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for a in arrays:
            f.write(a.tobytes())
    return os.path.getsize(path)


def load_safetensors(path: str) -> Dict[str, np.ndarray]:
    """A safetensors file -> {name: numpy array}; BF16 widens to f32 (exact)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        lo, hi = info["data_offsets"]
        if info["dtype"] == "BF16":
            bits = np.frombuffer(data[lo:hi], "<u2").astype(np.uint32) << 16
            a = bits.view(np.float32)
        else:
            a = np.frombuffer(data[lo:hi], np.dtype(_DTYPES[info["dtype"]]).newbyteorder("<"))
        out[name] = a.reshape(info["shape"]).copy()
    return out


def export_state_dict(model_or_state_dict: Union[torch.nn.Module, Mapping[str, torch.Tensor]]
                      ) -> Dict[str, np.ndarray]:
    """The port's state dict -> HF `CLIPModel` state dict (f32 numpy,
    C-contiguous), `logit_scale` 0-d."""
    sd = model_or_state_dict
    if isinstance(sd, torch.nn.Module):
        sd = sd.state_dict()
    out = {k: v.detach().float().cpu().contiguous().numpy() for k, v in sd.items()}
    out["logit_scale"] = out["logit_scale"].reshape(())
    return out


def hf_config_dict(cfg: CLIPConfig) -> Dict[str, Any]:
    """transformers `CLIPConfig` json for this architecture, `quick_gelu`
    pinned explicitly (what OpenAI CLIP checkpoints and `CLIPModule`
    compute)."""
    return {
        "architectures": ["CLIPModel"],
        "model_type": "clip",
        "projection_dim": cfg.projection_dim,
        "logit_scale_init_value": cfg.logit_scale_init,
        "text_config": {
            "model_type": "clip_text_model",
            "vocab_size": cfg.text.vocab_size,
            "hidden_size": cfg.text.hidden_size,
            "intermediate_size": cfg.text.mlp_dim,
            "num_hidden_layers": cfg.text.num_layers,
            "num_attention_heads": cfg.text.num_heads,
            "max_position_embeddings": cfg.text.max_length,
            "layer_norm_eps": cfg.text.layer_norm_eps,
            "hidden_act": "quick_gelu",
            "attention_dropout": 0.0,
            "eos_token_id": cfg.text.eos_token_id,
            "bos_token_id": cfg.text.eos_token_id - 1,
            "pad_token_id": cfg.text.eos_token_id,
            "projection_dim": cfg.projection_dim,
        },
        "vision_config": {
            "model_type": "clip_vision_model",
            "hidden_size": cfg.vision.hidden_size,
            "intermediate_size": cfg.vision.mlp_dim,
            "num_hidden_layers": cfg.vision.num_layers,
            "num_attention_heads": cfg.vision.num_heads,
            "image_size": cfg.vision.image_size,
            "patch_size": cfg.vision.patch_size,
            "layer_norm_eps": cfg.vision.layer_norm_eps,
            "hidden_act": "quick_gelu",
            "attention_dropout": 0.0,
            "num_channels": 3,
            "projection_dim": cfg.projection_dim,
        },
    }


def preprocessor_config_dict(cfg: CLIPConfig) -> Dict[str, Any]:
    return {
        "image_processor_type": "CLIPImageProcessor",
        "processor_class": "CLIPProcessor",
        "do_resize": True,
        "size": {"shortest_edge": cfg.vision.image_size},
        "resample": 3,  # PIL BICUBIC, as the pipeline's resize_crop_uint8
        "do_center_crop": True,
        "crop_size": {"height": cfg.vision.image_size, "width": cfg.vision.image_size},
        "do_rescale": True,
        "rescale_factor": 1 / 255,
        "do_normalize": True,
        "image_mean": CLIP_IMAGE_MEAN,
        "image_std": CLIP_IMAGE_STD,
        "do_convert_rgb": True,
    }


def save_pretrained(model_or_state_dict, cfg: CLIPConfig, out_dir: str,
                    tokenizer_dir: Optional[str] = None) -> None:
    """Write an HF snapshot dir loadable by `CLIPModel.from_pretrained`.

    `tokenizer_dir`: also copy its vocab.json + merges.txt and write a
    minimal tokenizer_config.json, so `CLIPProcessor.from_pretrained`
    works on the snapshot too."""
    os.makedirs(out_dir, exist_ok=True)
    # metadata format "pt": transformers' loader rejects files that do not
    # declare a torch-compatible format.
    save_safetensors(os.path.join(out_dir, "model.safetensors"),
                     export_state_dict(model_or_state_dict), metadata={"format": "pt"})
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(hf_config_dict(cfg), f, indent=2)
    with open(os.path.join(out_dir, "preprocessor_config.json"), "w") as f:
        json.dump(preprocessor_config_dict(cfg), f, indent=2)
    if tokenizer_dir:
        for name in ("vocab.json", "merges.txt"):
            src = os.path.join(tokenizer_dir, name)
            if not os.path.exists(src):
                raise FileNotFoundError(f"tokenizer_dir given but {src} does not exist")
            shutil.copy(src, os.path.join(out_dir, name))
        with open(os.path.join(out_dir, "tokenizer_config.json"), "w") as f:
            json.dump({"tokenizer_class": "CLIPTokenizer",
                       "model_max_length": cfg.text.max_length}, f, indent=2)
