"""Device image ops: CLIP pixel normalization, the region crop-resize, the
context view's black-out and the whole-frame resizes (counterpart of
`dclip_tpu/ops/image_ops.py`).

`crop_resize` crops an xyxy box (fractional pixel coordinates) out of an
image and squash-resizes it, with the antialiased triangle filter of
`jax.image.scale_and_translate(method="linear", antialias=True)`, which
the JAX package calls. torch has no builtin that matches it
(`F.interpolate(antialias=True)` cannot take a fractional box), so the
filter's weights are built explicitly by the rule of jax's
`compute_weight_mat` (`jax/_src/image/scale.py`), one [out, in] matrix
per spatial axis and box, and the crop is their contraction with the
image: two f32 matmuls. The JAX package leaves this to XLA outside any
Pallas kernel, so it stays plain torch here. XLA's compiled crop rounds
differently from the formula it compiles (it folds 1 / (out / length)
into length * (1 / out) and fuses multiply-adds, as it fuses the vmapped
program), so the two crops agree to a few 1e-6 in [0, 1] intensities, not
bitwise.

`resize_frames` is `jax.image.resize(..., "bilinear")` over whole frames:
the same triangle weights at scale out / in and translation 0, an axis
whose size does not change left as it is (jax skips it), antialiased when
it shrinks (`F.interpolate(mode="bilinear")` is not). `black_out_boxes`
and `resize_center_crop` build on it as the JAX functions do.
"""
from __future__ import annotations

import torch

# OpenAI CLIP normalization constants.
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
_EPS32 = float(torch.finfo(torch.float32).eps)


def normalize(images: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] in [0, 1] -> CLIP-normalized, same dtype and device."""
    mean = torch.tensor(CLIP_MEAN, dtype=images.dtype, device=images.device)
    std = torch.tensor(CLIP_STD, dtype=images.dtype, device=images.device)
    return (images - mean) / std


def triangle_weights(in_size: int, out_size: int, scale: torch.Tensor,
                     translation: torch.Tensor) -> torch.Tensor:
    """Antialiased linear resampling weights [n, out, in] f32 for n (scale,
    translation) pairs, by jax's `compute_weight_mat`: output pixel j
    samples input coordinate (j + 0.5) / scale - translation / scale - 0.5;
    the triangle widens by max(1 / scale, 1) when downscaling; rows are
    normalised to sum 1 where the sum is not ~0, and samples outside
    [-0.5, in - 0.5] get no weight."""
    inv = 1.0 / scale.float()
    kernel_scale = torch.clamp(inv, min=1.0)
    j = torch.arange(out_size, dtype=torch.float32, device=scale.device)
    sample = (j[None] + 0.5) * inv[:, None] - translation.float()[:, None] * inv[:, None] - 0.5
    i = torch.arange(in_size, dtype=torch.float32, device=scale.device)
    x = (sample[:, :, None] - i[None, None]).abs() / kernel_scale[:, None, None]
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(-1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _EPS32,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[..., None], w, torch.zeros_like(w))


def crop_resize_many(images: torch.Tensor, image_index: torch.Tensor, boxes: torch.Tensor,
                     out_size: int = 224) -> torch.Tensor:
    """Crop n boxes [n, 4] (xyxy, pixels) out of images [B, H, W, C], box k
    from image `image_index[k]`, each squash-resized to out_size x out_size:
    [n, out, out, C] f32. Widths and heights below 1 are taken as 1."""
    _, h, w, c = images.shape
    x1, y1, x2, y2 = boxes.float().unbind(-1)
    sy = out_size / torch.clamp(y2 - y1, min=1.0)
    sx = out_size / torch.clamp(x2 - x1, min=1.0)
    wy = triangle_weights(h, out_size, sy, -y1 * sy)  # [n, out, H]
    wx = triangle_weights(w, out_size, sx, -x1 * sx)  # [n, out, W]
    n = boxes.shape[0]
    src = images.float()[image_index].reshape(n, h, w * c)
    rows = torch.matmul(wy, src).reshape(n, out_size, w, c)          # [n, o, W, C]
    rows = rows.permute(0, 2, 1, 3).reshape(n, w, out_size * c)       # [n, W, o*C]
    out = torch.matmul(wx, rows).reshape(n, out_size, out_size, c)    # [n, q, o, C]
    return out.permute(0, 2, 1, 3)


def crop_resize(image: torch.Tensor, box: torch.Tensor, out_size: int = 224) -> torch.Tensor:
    """One box (xyxy) of image [H, W, C] -> [out, out, C] f32: the JAX
    package's `crop_resize` (`image.crop(box)` + squash `Resize`)."""
    index = torch.zeros(1, dtype=torch.long, device=image.device)
    return crop_resize_many(image[None], index, box.reshape(1, 4), out_size)[0]


def batch_crop_resize_normalize(images: torch.Tensor, boxes: torch.Tensor,
                                out_size: int = 224) -> torch.Tensor:
    """Every crop at once: images [B, H, W, 3] in [0, 1], boxes [B, P, 4]
    -> CLIP-normalized patches [B, P, out, out, 3] f32. An all-zero
    (invalid) box gives a defined patch; callers mask downstream."""
    b, p = boxes.shape[:2]
    index = torch.arange(b, device=images.device).repeat_interleave(p)
    crops = crop_resize_many(images, index, boxes.reshape(b * p, 4), out_size)
    return normalize(crops).reshape(b, p, out_size, out_size, images.shape[-1])


def black_out_boxes(images: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """The context view: images [B, H, W, C], boxes [B, P, 4] xyxy ->
    [B, P, H, W, C], view (b, p) image b with the pixels of box p zeroed.
    Pixel (y, x) lies in a box when y1 <= y < y2 and x1 <= x < x2, on float
    pixel indices, so a degenerate box zeroes nothing."""
    _, h, w, _ = images.shape
    ys = torch.arange(h, dtype=torch.float32, device=images.device)[None, None, :]
    xs = torch.arange(w, dtype=torch.float32, device=images.device)[None, None, :]
    x1, y1, x2, y2 = (boxes[..., i, None].float() for i in range(4))  # [B, P, 1]
    in_y = (ys >= y1) & (ys < y2)  # [B, P, H]
    in_x = (xs >= x1) & (xs < x2)  # [B, P, W]
    inside = in_y[:, :, :, None] & in_x[:, :, None, :]  # [B, P, H, W]
    return torch.where(inside[..., None], torch.zeros((), dtype=images.dtype,
                                                      device=images.device), images[:, None])


def _frame_weights(in_size: int, out_size: int, device) -> torch.Tensor:
    """[out, in] antialiased triangle weights of a whole-frame resize."""
    scale = torch.tensor([out_size / in_size], dtype=torch.float32, device=device)
    return triangle_weights(in_size, out_size, scale, torch.zeros_like(scale))[0]


def resize_frames(images: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Whole frames [N, H, W, C] -> [N, out_h, out_w, C] f32, as
    `jax.image.resize(images, (N, out_h, out_w, C), "bilinear")`."""
    x = images.float()
    n, h, w, c = x.shape
    if out_h != h:
        x = torch.matmul(_frame_weights(h, out_h, x.device), x.reshape(n, h, w * c))
        x = x.reshape(n, out_h, w, c)
    if out_w != w:
        x = torch.einsum("qw,nowc->noqc", _frame_weights(w, out_w, x.device), x)
    return x


def resize_center_crop(image: torch.Tensor, size: int = 224) -> torch.Tensor:
    """image [H, W, C] -> [size, size, C] f32: the shorter side resized to
    `size` (antialiased bilinear, sides rounded with Python's `round`), then
    the centred size x size window."""
    h, w = image.shape[0], image.shape[1]
    scale = size / min(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    resized = resize_frames(image[None], nh, nw)[0]
    top, left = (nh - size) // 2, (nw - size) // 2
    return resized[top:top + size, left:left + size]
