"""Operations and bytes of the kernels the per-layer rooflines read,
computed from the configuration's shapes alone (never from which kernel
does the work): the least time the card could take for them is the larger
of the operations over the bf16 peak and the bytes over the memory peak.
Each input byte is counted read once and each output byte written once.
"""
from __future__ import annotations

from benchmark.frozen import flops


def tower_params(tower, extra: int) -> int:
    """Encoder layers of a tower plus `extra` leaves' elements."""
    d, m = tower.hidden_size, tower.mlp_dim
    per_layer = 4 * d * d + 4 * d + 2 * d * m + m + d + 4 * d
    return tower.num_layers * per_layer + extra


def vision_params(shapes) -> int:
    v = shapes.vision
    n_pos = (v.image_size // v.patch_size) ** 2 + 1
    extra = (3 * v.patch_size ** 2 * v.hidden_size + (n_pos + 1) * v.hidden_size
             + 4 * v.hidden_size + v.hidden_size * shapes.projection_dim)
    return tower_params(v, extra)


def text_params(shapes) -> int:
    t = shapes.text
    extra = ((t.vocab_size + t.max_length) * t.hidden_size + 2 * t.hidden_size
             + t.hidden_size * shapes.projection_dim)
    return tower_params(t, extra)


def region_encode_least_s(shapes, crops: int, peaks) -> float:
    """The teacher image tower over `crops` crops: f32 pixels in, bf16
    weights once, bf16 features out."""
    v = shapes.vision
    ops = crops * flops.vision_forward_flops(shapes)
    data = (crops * v.image_size ** 2 * 3 * 4 + 2 * vision_params(shapes)
            + crops * shapes.projection_dim * 2)
    return max(ops / peaks.bf16, data / peaks.hbm)


def student_forward_least_s(shapes, images: int, caption_tokens, peaks) -> float:
    """The student's image tower over `images` images and text tower over
    captions of the given token counts: f32 pixels and int32 ids in, bf16
    weights once, bf16 features out."""
    v = shapes.vision
    tokens = list(caption_tokens)
    ops = images * flops.vision_forward_flops(shapes) + flops.text_tokens_forward_flops(shapes,
                                                                                        tokens)
    data = (images * v.image_size ** 2 * 3 * 4 + sum(tokens) * 4
            + 2 * (vision_params(shapes) + text_params(shapes))
            + (images + len(tokens)) * shapes.projection_dim * 2)
    return max(ops / peaks.bf16, data / peaks.hbm)
