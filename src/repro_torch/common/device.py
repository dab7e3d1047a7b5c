"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: the
default is ``"cuda"``, and a CUDA request without a card raises rather
than quietly running on the host.
"""
from __future__ import annotations

from typing import Union

import torch

Device = Union[str, torch.device]


def resolve_device(device: Device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on the GPU "
                "by default — pass device='cpu' to run on the host")
        # the reference computes in full fp32; cuDNN convolutions default
        # to TF32 (about three decimal digits), so turn TF32 off for both
        # convolutions and matmuls to keep the card on the same arithmetic
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        # cuDNN's default convolution algorithms are not deterministic, so
        # two identical FL rounds on VGG16 came out different; its
        # deterministic ones make them bitwise equal (chip_smoke.py
        # [round-repeat]).  No other op of the round needed it: under
        # torch.use_deterministic_algorithms(True, warn_only=True) nothing
        # warned, so that switch (and CUBLAS_WORKSPACE_CONFIG) is not set
        torch.backends.cudnn.deterministic = True
    return dev
