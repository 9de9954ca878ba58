from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: F401
