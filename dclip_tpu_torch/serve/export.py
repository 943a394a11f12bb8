"""Export / load of the CLIP encode functions as `torch.export` programs
(counterpart of `dclip_tpu/serve/export.py`).

`export_encoders` traces the text and image encode functions for each
serving bucket and platform and writes them, a manifest and one
`params.npz` to a directory; `load_exported` rehydrates callables from
the artifact alone (no `CLIPModule`, no config classes).

Weights are an ARGUMENT of every program, stored once in `params.npz`
under the JAX package's `//` key scheme, never lifted into a program: a
lifted copy would repeat the model in every (modality, bucket, platform)
file, and int8 weights would be stored dequantized. So the program is
traced from a function of (params, inputs) that runs the model through
`torch.func.functional_call` on a meta-device copy of the module, which
holds no data; the exported program's `state_dict` and `constants` are
empty, and its example inputs are dropped before it is saved.

The programs trace the module route: the model's plain ops
(`get_text_features`, `image_features`) or, with `quantize="int8"`,
`serve.quant`. The hand-written kernels run through ctypes and cannot be
traced, so a model whose serving route is the kernels' (bf16 on CUDA, or
built with a fused flag) is refused rather than traced as something
else: export an f32 model, or int8. A program is traced per platform
(`cpu`, `cuda`), because the tensors the module creates carry the trace
device; files are named `<modality>_b<batch>.<platform>.pt2`.
"""
from __future__ import annotations

import functools
import json
import os
from collections.abc import Mapping
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from dclip_tpu_torch.core.device import resolve_device
from dclip_tpu_torch.serve import quant
from dclip_tpu_torch.serve.quant import to_device
from dclip_tpu_torch.serve.service import _pad_rows, normalized

FORMAT = "dclip_tpu_torch.serve.export/1"
PLATFORMS = ("cpu", "cuda")
_MANIFEST = "manifest.json"
_PARAMS = "params.npz"
_KEY_SEP = "//"  # path separator in params.npz keys ('/' can appear in names)


def _save_params_npz(path: str, tree: Mapping[str, Any]) -> int:
    """Write a nested dict of arrays as a flat npz; returns bytes written."""
    flat: Dict[str, np.ndarray] = {}

    def walk(prefix, node):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(prefix + [str(k)], v)
        else:
            flat[_KEY_SEP.join(prefix)] = np.asarray(node)

    walk([], tree)
    with open(path, "wb") as f:
        np.savez(f, **flat)
    return os.path.getsize(path)


def _load_params_npz(path: str) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    with np.load(path) as z:
        for key in z.files:
            parts = key.split(_KEY_SEP)
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]
    return tree


class _Method(torch.nn.Module):
    """`model.<method>(*inputs)` as a forward, for `functional_call`."""

    def __init__(self, model, method: str):
        super().__init__()
        self.model = model
        self.method = method

    def forward(self, *inputs):
        return getattr(self.model, self.method)(*inputs)


class _Program(torch.nn.Module):
    """The exported module: `forward(params, *inputs)` -> f32 L2-normalized
    embeddings. It registers no submodule, so it lifts no state."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, params, *inputs):
        return normalized(self.fn(params, *inputs))


def _uses_kernels(model) -> bool:
    """True when some forward of `model` reaches a hand-written kernel."""
    flags = ("fused", "fused_frozen_mlp", "fused_trainable_mlp", "fused_trainable_attn_block")
    return any(getattr(m, f, False) for m in model.modules() for f in flags)


def check_platforms(platforms: Sequence[str]) -> Tuple[str, ...]:
    """The export targets, deduplicated; any but `cpu` / `cuda` raises."""
    platforms = tuple(dict.fromkeys(platforms))
    bad = [p for p in platforms if p not in PLATFORMS]
    if bad or not platforms:
        raise ValueError(f"export platforms must be among {PLATFORMS}, got {platforms}")
    return platforms


def export_encoders(
    model,
    cfg,
    out_dir: str,
    batch_sizes: Sequence[int] = (1, 8, 32),
    platforms: Optional[Sequence[str]] = None,
    quantize: Optional[str] = None,
) -> Dict[str, int]:
    """Write the text / image encoders of `model` (a `CLIPModule` holding
    its weights) for each batch size and platform into `out_dir`.

    platforms: `cpu` and / or `cuda` (default: the model's device type);
    `cuda` needs a card. quantize="int8" stores int8 weights
    (`serve.quant`) and traces the int8 forward, in bf16 on `cuda` and f32
    on `cpu`. Returns {file name: bytes written}, "params.npz" included."""
    from dclip_tpu_torch.models.clip import CLIPModule
    from dclip_tpu_torch.models.encoding import image_route, model_device

    if quantize not in (None, "int8"):
        raise ValueError(f"quantize must be None or 'int8', got {quantize!r}")
    platforms = check_platforms(platforms or (model_device(model).type,))
    devices = {p: resolve_device(p) for p in platforms}  # cuda without a card raises
    if quantize is None:
        routes = {p: image_route(d, model.dtype) for p, d in devices.items()}
        if _uses_kernels(model) or "kernels" in routes.values():
            raise ValueError(
                f"export: the model's serving route reaches the hand-written kernels "
                f"({model.dtype}, platforms {platforms}), which torch.export cannot trace; "
                f"export an f32 model built without fused flags, or quantize='int8'")
        params_tree: Dict[str, Any] = {k: v.detach().cpu().numpy()
                                       for k, v in model.state_dict().items()}
        shell = CLIPModule(cfg, dtype=model.dtype, device="meta").eval()

        def encoder(method):
            wrapped = _Method(shell, method)
            return lambda params, *inputs: torch.func.functional_call(
                wrapped, {f"model.{k}": v for k, v in params.items()}, inputs)

        fns = {"text": encoder("get_text_features"), "image": encoder("image_features")}
    else:
        params_tree = quant.quantize_clip(model, cfg)
        fns = {"text": functools.partial(quant.quantized_text_features, cfg),
               "image": functools.partial(quant.quantized_image_features, cfg)}

    os.makedirs(out_dir, exist_ok=True)
    written = {_PARAMS: _save_params_npz(os.path.join(out_dir, _PARAMS), params_tree)}
    text_len, size = cfg.text.max_length, cfg.vision.image_size
    entries = {(m, b): {"modality": m, "batch": b, "files": {}}
               for b in sorted(set(batch_sizes)) for m in ("text", "image")}
    for platform, dev in devices.items():
        params = to_device(params_tree, dev)
        for (modality, b), entry in entries.items():
            if modality == "text":
                inputs = (torch.zeros((b, text_len), dtype=torch.int32, device=dev),
                          torch.ones((b, text_len), dtype=torch.int32, device=dev))
            else:
                inputs = (torch.zeros((b, size, size, 3), dtype=torch.float32, device=dev),)
            with torch.no_grad():
                ep = torch.export.export(_Program(fns[modality]), (params, *inputs),
                                         strict=False)
            ep.example_inputs = None  # the example params would be saved with it
            name = f"{modality}_b{b}.{platform}.pt2"
            torch.export.save(ep, os.path.join(out_dir, name))
            written[name] = os.path.getsize(os.path.join(out_dir, name))
            entry["files"][platform] = name
        del params
    manifest = {
        "format": FORMAT,
        "params_file": _PARAMS,
        "projection_dim": cfg.projection_dim,
        "text_max_length": text_len,
        "image_size": size,
        "quantize": quantize,
        "platforms": list(platforms),
        "entries": list(entries.values()),
    }
    with open(os.path.join(out_dir, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    return written


class ExportedEncoders:
    """A loaded artifact: `.encode_texts_ids(ids, mask)` and
    `.encode_images(pixels)` (host numpy in and out) pick the smallest
    exported batch >= n and pad, as `ClipService` does."""

    def __init__(self, manifest: dict, fns: Dict[Tuple[str, int], Callable],
                 device: torch.device):
        self.manifest = manifest
        self.device = device
        self._fns = fns
        self.text_buckets = sorted(b for (m, b) in fns if m == "text")
        self.image_buckets = sorted(b for (m, b) in fns if m == "image")

    def _run(self, modality: str, buckets, arrays) -> np.ndarray:
        n = arrays[0].shape[0]
        if n == 0:
            return np.zeros((0, self.manifest["projection_dim"]), np.float32)
        out = []
        step = max(buckets)
        with torch.inference_mode():
            for lo in range(0, n, step):
                hi = min(lo + step, n)
                b = next(bb for bb in buckets if bb >= hi - lo)
                padded = [torch.as_tensor(_pad_rows(a[lo:hi], b), device=self.device)
                          for a in arrays]
                out.append(self._fns[(modality, b)](*padded)[: hi - lo].cpu().numpy())
        return np.concatenate(out, axis=0)

    def encode_texts_ids(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """[N, T] int32 ids and mask -> [N, P] f32, L2-normalized."""
        return self._run("text", self.text_buckets,
                         [np.asarray(ids, np.int32), np.asarray(mask, np.int32)])

    def encode_images(self, pixels: np.ndarray) -> np.ndarray:
        """[N, H, W, 3] f32 CLIP-normalized pixels -> [N, P] f32."""
        return self._run("image", self.image_buckets, [np.asarray(pixels, np.float32)])


def load_exported(out_dir: str, device="cuda") -> ExportedEncoders:
    """Load an artifact of `export_encoders` on `device` (default the card;
    "cpu" when asked for): `params.npz` is moved there once, and each
    entry's program for that device type is loaded."""
    device = resolve_device(device)
    path = os.path.join(out_dir, _MANIFEST)
    if not os.path.isfile(path):
        raise ValueError(f"not a dclip_tpu_torch export artifact: {out_dir} (no {_MANIFEST})")
    with open(path) as f:
        manifest = json.load(f)
    if manifest.get("format") != FORMAT:
        raise ValueError(f"not a dclip_tpu_torch export artifact: {out_dir} "
                         f"(format {manifest.get('format')!r}, expected {FORMAT!r})")
    if device.type not in manifest["platforms"]:
        raise ValueError(f"{out_dir} was exported for {manifest['platforms']}, not "
                         f"{device.type}")
    params = to_device(_load_params_npz(os.path.join(out_dir, manifest["params_file"])),
                         device)
    fns: Dict[Tuple[str, int], Callable] = {}
    for e in manifest["entries"]:
        program = torch.export.load(os.path.join(out_dir, e["files"][device.type])).module()
        fns[(e["modality"], int(e["batch"]))] = (
            lambda *inputs, _program=program: _program(params, *inputs))
    return ExportedEncoders(manifest, fns, device)
