"""The port's device rule: the card, unless the caller names another device.

Every entry point (the `zoo` loaders, `Wrapper`, `PoseExtractor`,
`PoseInference`, `TopDownInference`, `WholeBodyInference`, the face and hand
extractors, `tracking.lk.pyramidal_lk` and the trackers over it)
resolves its `device` argument here.  Given none it asks for `"cuda"` and
raises `NoCudaDeviceError` where there is no card: nothing carries on on the
CPU on its own.  Tests and CPU users pass `device="cpu"`.
"""

from __future__ import annotations

from typing import Union

import torch


class NoCudaDeviceError(RuntimeError):
    """No device was named and no CUDA device is available."""


def default_device() -> torch.device:
    """The current CUDA device; raises `NoCudaDeviceError` without one."""
    if not torch.cuda.is_available():
        raise NoCudaDeviceError(
            "openpose_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def resolve(device: Union[str, torch.device, None]) -> torch.device:
    """`device` as a torch.device; None means `default_device()`."""
    return default_device() if device is None else torch.device(device)
