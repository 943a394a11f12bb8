"""Zero-shot classification eval, the ImageNet-1k and CIFAR-10/100
protocols (counterpart of `dclip_tpu/eval/zero_shot.py:42-300`).

- prompts "a photo of a {name}" (ImageNet) and "a photo of a {name}, a
  type of object" (CIFAR);
- logits = 100 * normalized image features @ normalized text features.T,
  the image features from the module path (`CLIPModule.image_features`
  at the model's dtype) for every model, as the JAX
  `zero_shot_logits_forward` runs `get_image_features`
  (`dclip_tpu/models/encoding.py:65-79`); the retrieval eval and the
  service take K1 / K2 for a bf16 model on the card instead
  (`models.encoding.image_route`);
- top-1 / top-5 from a stable descending sort of each row, so a tie goes
  to the lower class index as in `jax.lax.top_k` (`ops.retrieval.stable_topk`,
  the rule of K12's twin);
- the comparison table and the results-file bodies of the JAX package,
  string for string.

CIFAR is read from the python pickle batches on disk, ImageNet from an
extracted ImageFolder tree (a .zip is extracted once); nothing is fetched.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dclip_tpu_torch.models.clip import CLIPModule
from dclip_tpu_torch.models.encoding import model_device, text_forward, zero_shot_logits
from dclip_tpu_torch.ops.losses import l2_normalize
from dclip_tpu_torch.ops.retrieval import stable_topk

CIFAR10_CLASSES = [
    "airplane", "automobile", "bird", "cat", "deer",
    "dog", "frog", "horse", "ship", "truck",
]

IMAGENET_PROMPT = "a photo of a {}"
CIFAR_PROMPT = "a photo of a {}, a type of object"


def embed_classnames(model: CLIPModule, tokenizer, classnames: Sequence[str],
                     prompt_template: str) -> torch.Tensor:
    """One text forward over every class prompt -> [C, P] f32, normalized,
    on the model's device."""
    prompts = [prompt_template.format(name) for name in classnames]
    ids, mask = tokenizer.encode_batch(prompts)
    return l2_normalize(text_forward(model, ids, mask).float())


def evaluate_zero_shot(model: CLIPModule, text_features: torch.Tensor,
                       image_batches: Iterable[Tuple[np.ndarray, np.ndarray]],
                       log_every: int = 50, mesh=None) -> Dict[str, float]:
    """Stream (pixels [B, H, W, 3] CLIP-normalized, labels [B]) batches ->
    {"top1", "top5", "total"}. With a `parallel.mesh.Mesh` of several
    ranks, every rank reads the same batches and takes its block of each
    (the last zero-padded, as the JAX eval pads to the data axis); the
    top-5 classes are all-gathered in order, so every rank counts every
    image; only the primary prints progress."""
    from dclip_tpu_torch.parallel.mesh import collective_device, gather_cat

    sharded = mesh is not None and mesh.distributed
    dev = model_device(model)
    image_fn = model.image_features
    text_features = torch.as_tensor(text_features, device=dev)
    correct1 = correct5 = total = 0
    for step, (pixels, labels) in enumerate(image_batches):
        pixels, labels = np.asarray(pixels), np.asarray(labels)
        n = len(labels)
        if sharded:
            per = -(-n // mesh.size)
            own = pixels[min(mesh.rank * per, n):min((mesh.rank + 1) * per, n)]
            pixels = np.concatenate(
                [own, np.zeros((per - len(own),) + pixels.shape[1:], pixels.dtype)])
        logits = zero_shot_logits(image_fn, torch.as_tensor(pixels, device=dev), text_features)
        _, top5 = stable_topk(logits, min(5, logits.shape[-1]))
        if sharded:
            top5 = gather_cat(top5.to(collective_device(mesh)), mesh)[:n]
        top5 = top5.cpu().numpy()
        correct1 += int((top5[:, 0] == labels).sum())
        correct5 += int((top5 == labels[:, None]).any(axis=1).sum())
        total += len(labels)
        if log_every and step % log_every == 0 and (mesh is None or mesh.is_primary):
            print(f"Processed {total} images - "
                  f"Top-1: {correct1 / max(total, 1):.4f}, "
                  f"Top-5: {correct5 / max(total, 1):.4f}")
    return {"top1": correct1 / max(total, 1), "top5": correct5 / max(total, 1), "total": total}


# -- data loading (nothing fetched) ------------------------------------------------


def load_cifar_batches(data_dir: str, dataset: str = "cifar10"
                       ) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """The CIFAR python pickle test batch from disk: cifar10
    <dir>/cifar-10-batches-py/test_batch, cifar100 <dir>/cifar-100-python/
    test. Returns (uint8 NHWC images, labels, classnames)."""
    if dataset == "cifar10":
        path = os.path.join(data_dir, "cifar-10-batches-py", "test_batch")
        meta = os.path.join(data_dir, "cifar-10-batches-py", "batches.meta")
        label_key, name_key = b"labels", b"label_names"
    elif dataset == "cifar100":
        path = os.path.join(data_dir, "cifar-100-python", "test")
        meta = os.path.join(data_dir, "cifar-100-python", "meta")
        label_key, name_key = b"fine_labels", b"fine_label_names"
    else:
        raise ValueError(dataset)
    with open(path, "rb") as f:
        d = pickle.load(f, encoding="bytes")
    images = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    labels = np.asarray(d[label_key], np.int64)
    with open(meta, "rb") as f:
        names = [n.decode() for n in pickle.load(f, encoding="bytes")[name_key]]
    return images, labels, names


def iterate_preprocessed(images: np.ndarray, labels: np.ndarray, batch_size: int = 64,
                         image_size: int = 224) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """uint8 NHWC -> CLIP-preprocessed batches (PIL bicubic, HF parity)."""
    from dclip_tpu_torch.data.pipeline import preprocess_image, require_pil

    Image = require_pil()
    for start in range(0, len(images), batch_size):
        chunk = images[start:start + batch_size]
        pixels = np.stack([preprocess_image(Image.fromarray(im), image_size) for im in chunk])
        yield pixels, labels[start:start + batch_size]


def ensure_extracted(data_dir: str) -> str:
    """Accept a .zip of an ImageFolder tree and extract it once; returns
    the directory (descending into a single top-level folder)."""
    if not data_dir.endswith(".zip"):
        return data_dir
    import shutil
    import zipfile

    target = data_dir[:-len(".zip")] + "_extracted"
    if not os.path.isdir(target):
        # Extract to a temporary name and rename, so that an interrupted
        # extraction is never taken for a complete dataset.
        tmp = target + ".partial"
        print(f"Extracting {data_dir} -> {target}")
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        with zipfile.ZipFile(data_dir) as z:
            z.extractall(tmp)
        os.rename(tmp, target)
    entries = [e for e in os.listdir(target) if not e.startswith(".")]
    if len(entries) == 1 and os.path.isdir(os.path.join(target, entries[0])):
        return os.path.join(target, entries[0])
    return target


def iterate_image_folder(root: str, batch_size: int = 64, image_size: int = 224
                         ) -> Tuple[List[str], Iterator[Tuple[np.ndarray, np.ndarray]]]:
    """An ImageFolder-layout directory -> (classnames, batches); classes are
    the sorted subdirectory names (torchvision's class_to_idx rule)."""
    classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
    samples: List[Tuple[str, int]] = []
    for idx, cls in enumerate(classes):
        cdir = os.path.join(root, cls)
        for fname in sorted(os.listdir(cdir)):
            if fname.lower().endswith((".jpg", ".jpeg", ".png", ".bmp", ".webp")):
                samples.append((os.path.join(cdir, fname), idx))

    def gen():
        from dclip_tpu_torch.data.pipeline import preprocess_image, require_pil

        Image = require_pil()
        for start in range(0, len(samples), batch_size):
            pixels, labels = [], []
            for path, label in samples[start:start + batch_size]:
                with Image.open(path) as im:
                    pixels.append(preprocess_image(im.convert("RGB"), image_size))
                labels.append(label)
            yield np.stack(pixels), np.asarray(labels, np.int64)

    return classes, gen()


# -- reporting, in the JAX package's formats -------------------------------------------


def format_cifar_results(base10: Dict, custom10: Dict, base100: Dict, custom100: Dict) -> str:
    """The cifar_zero_shot_results.txt body."""

    def rel(c, b):
        return (c["top1"] - b["top1"]) / b["top1"] * 100 if b["top1"] > 0 else 0.0

    lines = [
        "Zero-Shot CIFAR Results",
        "=" * 70,
        "CIFAR-10:",
        f"Base CLIP Top-1: {base10['top1']:.4f}, Top-5: {base10['top5']:.4f}",
        f"Custom Model Top-1: {custom10['top1']:.4f}, Top-5: {custom10['top5']:.4f}",
        f"Relative Change: {rel(custom10, base10):+.2f}%",
        "",
        "CIFAR-100:",
        f"Base CLIP Top-1: {base100['top1']:.4f}, Top-5: {base100['top5']:.4f}",
        f"Custom Model Top-1: {custom100['top1']:.4f}, Top-5: {custom100['top5']:.4f}",
        f"Relative Change: {rel(custom100, base100):+.2f}%",
    ]
    return "\n".join(lines) + "\n"


def format_imagenet_results(custom: Dict, base: Optional[Dict] = None) -> str:
    """The imagenet_zero_shot_results.txt body."""
    lines = ["Zero-Shot ImageNet Results"]
    if base is not None:
        lines.append(f"Base CLIP Top-1: {base['top1']:.4f}")
        lines.append(f"Base CLIP Top-5: {base['top5']:.4f}")
        lines.append("")
    lines.append(f"Custom Model Top-1: {custom['top1']:.4f}")
    lines.append(f"Custom Model Top-5: {custom['top5']:.4f}")
    return "\n".join(lines) + "\n\n"


def print_comparison_table(results: Dict[str, Dict[str, Dict]]) -> None:
    """The console table of every dataset and model."""
    print("\nZero-Shot Results")
    print("=" * 70)
    print(f"{'Model':<15} {'Dataset':<10} {'Top-1 Acc':<15} {'Top-5 Acc':<15} {'Rel. Change':<15}")
    print("-" * 70)
    for dataset, models in results.items():
        base = models.get("base")
        for model_name, res in models.items():
            if base is not None and model_name != "base" and base["top1"] > 0:
                rel = f"{(res['top1'] - base['top1']) / base['top1'] * 100:+.2f}%"
            else:
                rel = "-"
            print(f"{model_name:<15} {dataset:<10} {res['top1']:<15.4f} "
                  f"{res['top5']:<15.4f} {rel:<15}")
