"""The plain student step: the benchmark's reference of the distillation
training step.

From the distillation's published objective, in plain PyTorch, importing
nothing of the program:

- loss = (1 - cos(student image, teacher image target)).mean()
       + (1 - cos(student text, teacher text target)).mean()
       + w * InfoNCE(student image, student text), symmetric, diagonal
         positives, at temperature tau;
- the trainable leaves are the default distillation mask: in the image
  tower only the leaves whose name holds "proj" (the attention projections
  and the visual projection), everything else (the text tower, the text
  projection, the logit scale) trains;
- gradient accumulation: each step's gradient is added up, and every
  `accumulate_grad_batches`-th step AdamW takes their mean;
- AdamW over them: the global norm of that mean (a leaf the loss does
  not reach has a zero gradient) clipped to `gradient_clip_val`,
  Adam's moments with bias correction, then + weight_decay * p, times
  -learning_rate (warm-up linear in the updates applied).

The batch's embeddings are computed in blocks without gradients, the loss
and its gradient with respect to them over the whole batch, then each
block again with gradients, its backward taking its rows of that
gradient: the same gradient as one whole-batch backward, in the memory of
one block.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference.clip import Precision, image_features, text_features


def trainable(name: str) -> bool:
    """The default distillation mask."""
    return ("proj" in name) if name.startswith("vision_model.") else True


def _cosine_distill(s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    def unit(x):
        return x / torch.sqrt(torch.clamp((x * x).sum(-1, keepdim=True), min=1e-24))
    return (1.0 - (unit(s) * unit(t)).sum(-1)).mean()


def _info_nce(img: torch.Tensor, txt: torch.Tensor, temperature: float) -> torch.Tensor:
    def unit(x):
        return x / torch.sqrt(torch.clamp((x * x).sum(-1, keepdim=True), min=1e-24))
    logits = unit(img) @ unit(txt).t() / temperature
    labels = torch.arange(logits.shape[0], device=logits.device)
    diag = logits[labels, labels]
    return ((torch.logsumexp(logits, 1) - diag).mean()
            + (torch.logsumexp(logits, 0) - diag).mean()) / 2.0


def loss_parts(img, txt, t_img, t_txt, train) -> Dict[str, torch.Tensor]:
    image = _cosine_distill(img, t_img)
    text = _cosine_distill(txt, t_txt)
    con = _info_nce(img, txt, train["temperature"])
    return {"image_distill_loss": image, "text_distill_loss": text, "contrastive_loss": con,
            "loss": image + text + train["contrastive_weight"] * con}


class ReferenceStudent:
    """The student's parameters and AdamW state, stepped in float32 (or in
    the control's precision)."""

    def __init__(self, params: Mapping[str, torch.Tensor], shapes, train: Mapping,
                 prec: Precision, block: int = 32):
        self.shapes, self.train, self.prec, self.block = shapes, dict(train), prec, block
        self.p = {n: t.detach().float().clone().requires_grad_(trainable(n))
                  for n, t in params.items()}
        self.names = [n for n in self.p if trainable(n)]
        self.mu = {n: torch.zeros_like(self.p[n]) for n in self.names}
        self.nu = {n: torch.zeros_like(self.p[n]) for n in self.names}
        self.acc = {n: torch.zeros_like(self.p[n]) for n in self.names}
        self.accumulate = max(int(self.train["accumulate_grad_batches"]), 1)
        self.micro = 0
        self.count = 0

    def _embed(self, pixels, ids, mask, rows: slice):
        img = image_features(self.p, self.shapes, pixels[rows], self.prec)
        txt = text_features(self.p, self.shapes, ids[rows], mask[rows], self.prec)
        return img, txt

    def step(self, batch: Mapping[str, np.ndarray], t_img: torch.Tensor, t_txt: torch.Tensor,
             device, rows: Optional[int] = None
             ) -> Tuple[Dict[str, float], Optional[Dict[str, torch.Tensor]]]:
        """One step on a host batch and its targets; `rows` < B takes the
        loss over the first rows only (the fault of a half batch). Returns
        (loss parts, {leaf: the clipped gradient the update used}, or None
        on a step that only accumulates)."""
        n = rows or t_img.shape[0]
        pixels = torch.from_numpy(batch["pixel_values"][:n]).to(device)
        ids = torch.from_numpy(batch["input_ids"][:n]).to(device)
        mask = torch.from_numpy(batch["attention_mask"][:n]).to(device)
        blocks = [slice(i, min(i + self.block, n)) for i in range(0, n, self.block)]
        with torch.no_grad():
            parts = [self._embed(pixels, ids, mask, r) for r in blocks]
        img = torch.cat([a for a, _ in parts]).requires_grad_(True)
        txt = torch.cat([b for _, b in parts]).requires_grad_(True)
        losses = loss_parts(img, txt, t_img[:n].float(), t_txt[:n].float(), self.train)
        d_img, d_txt = torch.autograd.grad(losses["loss"], (img, txt))
        for name in self.names:
            self.p[name].grad = None
        for r in blocks:
            a, b = self._embed(pixels, ids, mask, r)
            ((a * d_img[r]).sum() + (b * d_txt[r]).sum()).backward()
        with torch.no_grad():
            for name in self.names:
                if self.p[name].grad is not None:
                    self.acc[name].add_(self.p[name].grad)
                self.p[name].grad = None
        self.micro += 1
        grads = None
        if self.micro % self.accumulate == 0:
            grads = self._update()
        return {k: float(v.detach()) for k, v in losses.items()}, grads

    @torch.no_grad()
    def _update(self) -> Dict[str, torch.Tensor]:
        t = self.train
        g = {n: self.acc[n] / self.accumulate for n in self.names}
        for a in self.acc.values():
            a.zero_()
        norm = torch.sqrt(sum((x.double() ** 2).sum() for x in g.values())).float()
        clip = t["gradient_clip_val"]
        if clip and float(norm) >= clip:
            g = {n: x / norm * clip for n, x in g.items()}
        warm = t["warmup_steps"]
        lr = t["learning_rate"] * (min((self.count + 1) / warm, 1.0) if warm > 0 else 1.0)
        self.count += 1
        b1, b2, eps, wd = t["adam_b1"], t["adam_b2"], t["adam_eps"], t["weight_decay"]
        c1, c2 = 1.0 - b1 ** self.count, 1.0 - b2 ** self.count
        for n in self.names:
            p, x = self.p[n], g[n]
            self.mu[n].mul_(b1).add_(x, alpha=1.0 - b1)
            self.nu[n].mul_(b2).addcmul_(x, x, value=1.0 - b2)
            update = (self.mu[n] / c1) / (torch.sqrt(self.nu[n] / c2) + eps) + wd * p
            p.sub_(lr * update)
        return g


def reference_run(params0: Mapping[str, torch.Tensor], shapes, train: Mapping,
                  batches: Sequence[Mapping[str, np.ndarray]],
                  targets: Sequence[Tuple[torch.Tensor, torch.Tensor]], device,
                  prec: Precision, rows: Optional[int] = None) -> dict:
    """The first len(batches) steps from params0: each step's loss parts,
    the norm per trainable leaf of the first update's clipped gradient,
    and the norm of each trainable leaf's change after the last step."""
    student = ReferenceStudent(params0, shapes, train, prec)
    losses: List[Dict[str, float]] = []
    grad_norms: Dict[str, float] = {}
    for k, (batch, (t_img, t_txt)) in enumerate(zip(batches, targets)):
        parts, grads = student.step(batch, t_img, t_txt, device, rows)
        losses.append(parts)
        if grads is not None and not grad_norms:
            grad_norms = {n: float(g.double().norm()) for n, g in grads.items()}
    change = {n: float((student.p[n].detach().double() - params0[n].double()).norm())
              for n in student.names}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
