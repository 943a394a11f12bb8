"""Trainers of the port: the student half of the distillation trainer
(`distill_trainer.DistillTrainer`), its masked AdamW (`optim`), the
teacher-target caches (`distill_trainer.TeacherTargetCache`,
`device_cache.DeviceTargetCache`) and the epoch loop (`base`)."""
