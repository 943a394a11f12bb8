"""Trainable-leaf masks, the warmup schedule and a masked AdamW that
matches the JAX package's optax chain (counterpart of
`dclip_tpu/train/optim.py:28-198`).

The JAX optimizer is

    MultiSteps(chain(masked(chain(clip_by_global_norm(c), adamw(lr_sched,
               weight_decay=0.01)), mask), masked(set_to_zero(), ~mask)), k)

`MaskedAdamW` computes the same updates on the trainable parameters:

- k mini-step gradients averaged by Welford's update
  acc += (g - acc) / (n + 1), parameters changed only on every k-th step;
- the global norm over the trainable leaves; above `grad_clip` every
  gradient becomes (g / norm) * grad_clip;
- Adam with b1 0.9, b2 0.999, eps 1e-8, bias correction by the count of
  applied updates, then + weight_decay * p, then * -lr(n) with
  lr(n) = lr * min((n + 1) / warmup, 1) and n the updates applied before;
- a trainable leaf the loss never reaches (`logit_scale`) has a zero
  gradient in optax, so it still decays and still counts in the norm:
  its missing `.grad` is taken as zeros here. Frozen leaves
  (`requires_grad=False`, the torch form of optim.py:149-196's
  frozen-leaf DCE) are never touched.

Every operation stays on the device: no host sync per step.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Mapping, Optional, Sequence, Tuple

import torch


def student_trainable_mask(names: Iterable[str], extra_patterns: Sequence[str] = (),
                           freeze_text: bool = False) -> Dict[str, bool]:
    """The default distillation mask (optim.py:50-73) over HF parameter
    names: vision_model leaves need "proj" in their name (or an extra
    pattern); every other leaf trains, except text_model leaves when
    `freeze_text` (then only those an extra pattern names)."""
    out = {}
    for name in names:
        extra = any(p in name for p in extra_patterns)
        if name.startswith("vision_model."):
            out[name] = ("proj" in name) or extra
        elif freeze_text and name.startswith("text_model."):
            out[name] = extra
        else:
            out[name] = True
    return out


def count_trainable(mask: Mapping[str, bool]) -> Tuple[int, int]:
    return sum(bool(v) for v in mask.values()), len(mask)


def linear_warmup_schedule(learning_rate: float, warmup_steps: int) -> Callable[[int], float]:
    """lr * min((n + 1) / warmup, 1); constant without warmup."""
    if warmup_steps <= 0:
        return lambda n: learning_rate
    return lambda n: learning_rate * min((n + 1) / warmup_steps, 1.0)


class MaskedAdamW:
    """AdamW over the trainable parameters with clipping, warmup and
    gradient accumulation; `step()` after every backward."""

    def __init__(self, params: Sequence[torch.nn.Parameter], learning_rate: float,
                 warmup_steps: int = 0, weight_decay: float = 0.01,
                 grad_clip: Optional[float] = None, accumulate_steps: int = 1,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.schedule = linear_warmup_schedule(learning_rate, warmup_steps)
        self.weight_decay, self.grad_clip = weight_decay, grad_clip
        self.accumulate_steps = max(int(accumulate_steps), 1)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.acc = ([torch.zeros_like(p) for p in self.params]
                    if self.accumulate_steps > 1 else None)
        self.mini_step = 0   # MultiSteps' mini_step
        self.count = 0       # applied updates (Adam's count, the schedule's step)

    def _grads(self):
        return [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]

    @torch.no_grad()
    def step(self) -> bool:
        """Consume the parameters' `.grad`; True when the parameters moved."""
        grads = self._grads()
        if self.acc is not None:
            n = self.mini_step
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (n + 1))
            self.mini_step = (n + 1) % self.accumulate_steps
            if self.mini_step:
                return False
            grads = [a.clone() for a in self.acc]
            for a in self.acc:
                a.zero_()
        if self.grad_clip is not None and self.grad_clip > 0:
            norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
            keep = norm < self.grad_clip
            grads = [torch.where(keep, g, (g / norm) * self.grad_clip) for g in grads]
        lr = self.schedule(self.count)
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.mul_(self.b1).add_((1.0 - self.b1) * g)
            nu.mul_(self.b2).add_((1.0 - self.b2) * (g * g))
            update = (mu / c1) / (torch.sqrt(nu / c2) + self.eps) + self.weight_decay * p
            p.add_(update * -lr)
        return True

    def state_dict(self) -> dict:
        """The moments, the accumulator and both counters as CPU tensors and
        ints, in the order of `params`."""
        def cpu(ts):
            return None if ts is None else [t.detach().cpu().clone() for t in ts]

        return {"count": self.count, "mini_step": self.mini_step, "mu": cpu(self.mu),
                "nu": cpu(self.nu), "acc": cpu(self.acc)}

    @torch.no_grad()
    def load_state_dict(self, state: Mapping) -> None:
        """Restore `state_dict()`'s output, copied onto the parameters'
        devices; raises on another number or shape of tensors."""
        for key in ("mu", "nu", "acc"):
            mine, theirs = getattr(self, key), state[key]
            if (mine is None) != (theirs is None) or (
                    mine is not None and [t.shape for t in mine] != [t.shape for t in theirs]):
                raise ValueError(f"optimizer state {key!r} does not match these parameters")
            for dst, src in zip(mine or (), theirs or ()):
                dst.copy_(src)
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])


def make_optimizer(params: Sequence[torch.nn.Parameter], learning_rate: float, *,
                   kind: str = "adamw", warmup_steps: int = 0,
                   grad_clip: Optional[float] = None, accumulate_steps: int = 1,
                   weight_decay: float = 0.01) -> MaskedAdamW:
    """Masked (Adam|AdamW) with optional warmup, clipping, accumulation,
    over `params` (the trainable ones)."""
    if kind not in ("adamw", "adam"):
        raise ValueError(f"unknown optimizer kind {kind!r}")
    return MaskedAdamW(params, learning_rate, warmup_steps,
                       weight_decay if kind == "adamw" else 0.0, grad_clip, accumulate_steps)


def make_train_step(loss_fn: Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]],
                    model: torch.nn.Module, optimizer: MaskedAdamW):
    """(*args) -> metrics: clear the gradients, run loss_fn(*args) ->
    (loss, metrics), backward, one optimizer step. The gradients stay on
    the parameters until the next call; metrics are detached device
    scalars."""

    def step(*args):
        for p in model.parameters():
            p.grad = None
        loss, metrics = loss_fn(*args)
        loss.backward()
        optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    return step
