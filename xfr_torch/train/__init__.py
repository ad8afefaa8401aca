"""Fine-tuning (port of xfr_tpu/train)."""

from xfr_torch.train.finetune import make_train_step  # noqa: F401
