"""Operations and bytes of SigLIP so400m's distillation step, from the
configuration's shapes alone (`reference.siglip.shapes`): the model FLOPs
that `siglip_train_mfu` reads and the least times that the SigLIP
rooflines read. Each input byte is counted read once and each output byte
written once; a launch's least time is the larger of its operations over
the bf16 peak and its bytes over the memory peak.

Model FLOPs follow the port's `student_step_flops_masked` convention (the
GEMMs the default trainable mask needs, recomputation not counted, the
text tower at its 64 computed positions). Attention counts its two
forward products (Q K^T, P V) and five backward ones (S again, dP, dS K,
dS^T Q, P^T dO), 2 S^2 D each a sequence and layer.
"""
from __future__ import annotations

from benchmark.reference.siglip import num_patches


def _layer(s: int, d: int, mlp: int) -> float:
    return 4 * 2 * s * d * d + 2 * 2 * s * s * d + 2 * 2 * s * d * mlp


def vision_forward_flops(sh) -> float:
    """One image: patch embedding, the layers, the attention-pooling head."""
    v = sh.vision
    s, d, m = num_patches(v), v.hidden_size, v.mlp_dim
    head = 2 * 2 * d * d + 2 * 2 * s * d * d + 2 * 2 * s * d + 2 * 2 * d * m
    return 2 * s * 3 * v.patch_size ** 2 * d + v.num_layers * _layer(s, d, m) + head


def text_forward_flops(sh) -> float:
    """One caption at every position, and the head at the last."""
    t = sh.text
    d = t.hidden_size
    return t.num_layers * _layer(t.max_length, d, t.mlp_dim) + 2 * d * d


def step_flops_per_image(sh) -> float:
    """Forward, the vision dX chain, the trainable projections' dW (the
    layers' q / k / v / out and the head's in_proj / out_proj), and the text
    tower three times its forward."""
    v = sh.vision
    s, d = num_patches(v), v.hidden_size
    fwd = vision_forward_flops(sh)
    patch = 2 * s * 3 * v.patch_size ** 2 * d
    dw = v.num_layers * 4 * 2 * s * d * d + 2 * 2 * d * d + 2 * 2 * s * d * d
    return fwd + (fwd - patch) + dw + 3.0 * text_forward_flops(sh)


def _least(ops: float, data: float, peaks) -> float:
    return max(ops / peaks.bf16, data / peaks.hbm)


def attention_least_s(sh, batch: int, peaks, forwards: int = 2) -> float:
    """The attention cores of one step, both towers: `forwards` forward
    launches a layer (two under remat) and one backward (dq and dk / dv),
    each over the whole batch."""
    total = 0.0
    for t, s in ((sh.vision, num_patches(sh.vision)), (sh.text, sh.text.max_length)):
        d, h = t.hidden_size, t.num_heads
        fwd = _least(batch * 2 * 2 * s * s * d,
                     batch * (4 * s * d * 2 + 2 * s * h * 4), peaks)
        bwd = _least(batch * 5 * 2 * s * s * d,
                     batch * (8 * s * d * 2 + 3 * s * h * 4), peaks)
        total += t.num_layers * (forwards * fwd + bwd)
    return total


def frozen_mlp_least_s(sh, batch: int, peaks, forwards: int = 2) -> float:
    """K6 over the vision layers of one step: LayerNorm, fc1 with tanh-GELU
    and a1 saved, fc2 with the residual (`forwards` times a layer); then
    g W2^T times tanh-GELU'(a1), that times W1^T into f32, and the LayerNorm
    backward with the residual (once)."""
    v = sh.vision
    rows, d, m = batch * num_patches(v), v.hidden_size, v.mlp_dim
    w = d * m * 2
    fwd = (_least(0, rows * d * 4 + d * 8, peaks)
           + _least(2 * rows * d * m, rows * d * 2 + w + rows * m * 4, peaks)
           + _least(2 * rows * m * d, rows * m * 2 + w + rows * d * 4, peaks))
    bwd = (_least(2 * rows * d * m, rows * d * 2 + w + rows * m * 4, peaks)
           + _least(2 * rows * m * d, rows * m * 2 + w + rows * d * 4, peaks)
           + _least(0, rows * d * 10 + d * 4, peaks))
    return v.num_layers * (forwards * fwd + bwd)
