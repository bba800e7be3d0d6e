"""Device selection for the port (counterpart of ``utils/jax_env.py``).

Every entry point of the port runs on CUDA unless its caller asks for the
CPU by name (``device='cpu'``, as the tests do). Without a card and
without that request it raises: it never drops quietly to the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]

H100_BF16_DENSE_FLOPS = 989e12  # tensor-core FLOP/s, H100 SXM data sheet


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means CUDA. Raises if CUDA is asked for and absent.

    Also turns TF32 off for float32 matmuls and convolutions, so that
    float32 results on the card are full float32 like the JAX reference's
    (cuDNN would otherwise run float32 convolutions in TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'CUDA is not available: skypilot_tpu_torch runs on an NVIDIA '
            "GPU unless the caller passes device='cpu'")
    return dev
