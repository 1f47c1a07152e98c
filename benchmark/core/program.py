"""The program under test, set up as a configuration file states it: the
port's ``ModelConfig`` and ``TrainConfig`` built from the file's ``model``
and ``train`` blocks, and its activation dtype and product precision set
through the port's own switches."""

from __future__ import annotations

import torch


def model_config(conf: dict):
    from supernet_tpu_torch.configs import ModelConfig

    m = dict(conf["model"])
    if m.get("bottleneck_pre_pad") is not None:
        m["bottleneck_pre_pad"] = tuple(m["bottleneck_pre_pad"])
    return ModelConfig(**m)


def train_config(conf: dict):
    from supernet_tpu_torch.configs import TrainConfig

    return TrainConfig(**conf["train"])


def set_precision(conf: dict) -> None:
    """The port's activation dtype and the precision of its products
    (under "highest" TF32 is off in PyTorch's own products too)."""
    from supernet_tpu_torch.ops import set_act_dtype, set_mxu_precision

    set_act_dtype(conf["precision"]["activations"])
    set_mxu_precision(conf["precision"]["products"])


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def release(device) -> None:
    import gc

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
