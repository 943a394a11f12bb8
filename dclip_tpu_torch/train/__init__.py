"""Trainers of the port: the distillation trainer
(`distill_trainer.DistillTrainer`: teacher targets through three cache
levels, the student step, the eval loss), its masked AdamW (`optim`), the
teacher-target caches (`distill_trainer.TeacherTargetCache`,
`device_cache.DeviceTargetCache`), and the epoch loop, the k-NN gate and the
budgeted patch encode (`base`)."""
