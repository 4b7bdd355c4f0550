from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    adafactor,
    adamw,
    apply_updates,
    clip_by_global_norm,
    global_norm,
    make_optimizer,
    sgd_momentum,
)
from repro_torch.optim.schedules import caffe_inv, constant, warmup_cosine  # noqa: F401
