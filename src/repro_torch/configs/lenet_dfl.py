"""The paper's own workload: LeNet-5 on MNIST-shaped inputs (28x28x1, 10 classes).

Copy of the JAX package's ``LeNetConfig`` (same fields and defaults); see
``repro_torch.models.lenet``.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class LeNetConfig:
    name: str = "lenet-dfl"
    image_size: int = 28
    in_channels: int = 1
    num_classes: int = 10
    conv_channels: tuple = (6, 16)
    fc_dims: tuple = (120, 84)
    # Caffe LeNet solver defaults (paper §VI-D): base_lr 0.01, momentum 0.9,
    # inv decay lr_t = base_lr * (1 + gamma*t)^-power
    base_lr: float = 0.01
    momentum: float = 0.9
    lr_gamma: float = 1e-4
    lr_power: float = 0.75


CONFIG = LeNetConfig()
