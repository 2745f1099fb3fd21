from repro_torch.training.loop import (
    TrainResult,
    make_loss_fn,
    make_train_step,
    train,
)

__all__ = ["TrainResult", "make_loss_fn", "make_train_step", "train"]
