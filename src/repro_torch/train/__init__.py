from repro_torch.train.loop import StragglerMonitor, train
from repro_torch.train.step import make_loss_and_grad, make_train_step

__all__ = ["StragglerMonitor", "train", "make_loss_and_grad",
           "make_train_step"]
