"""Trainers of the port: the distillation trainer
(`distill_trainer.DistillTrainer`: teacher targets through three cache
levels, the student step, the eval loss), the meta-teacher trainer
(`teacher_trainer.TeacherTrainer`: the cross-attention trained on K10's
differentiable form), their masked Adam / AdamW (`optim`), the
teacher-target caches (`distill_trainer.TeacherTargetCache`,
`device_cache.DeviceTargetCache`), the epoch loop, the k-NN gate and the
budgeted patch encode (`base`), and cooperative SIGTERM preemption
(`preemption`)."""
from dclip_tpu_torch.train.teacher_trainer import TeacherTrainer, masked_mean

__all__ = ["TeacherTrainer", "masked_mean"]
