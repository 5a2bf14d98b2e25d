"""Where an entry point runs when the caller does not say."""

from __future__ import annotations

import torch


def resolve_device(device, *arrays) -> torch.device:
    """The device an entry point runs on.

    - ``device`` given: that device.
    - ``device=None`` and one of ``arrays`` is a tensor (or a cached
      ``KinshipDecomposition`` or a ``LowRankKinship``, which lie where
      their factors lie): the first such tensor's device (a CPU tensor is
      the caller asking for the CPU).
    - ``device=None`` and only numpy arrays or lists: the current CUDA
      device. Without one this raises instead of running on the CPU
      unasked; ``device="cpu"`` runs the plain PyTorch versions there.
    """
    if device is not None:
        return torch.device(device)
    for a in arrays:
        a = getattr(a, "Ut", a)  # KinshipDecomposition
        a = getattr(a, "U", a)  # LowRankKinship
        if torch.is_tensor(a):
            return a.device
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    raise RuntimeError(
        "no CUDA device was found and no input is a tensor, so there is no "
        "device to run on by default: pass device=\"cpu\" to run the plain "
        "PyTorch versions on the CPU (or pass tensors that lie on the device "
        "you want)"
    )


def refuse_mesh(mesh) -> None:
    """Refuse a device mesh: the sharded engines are not ported yet."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (the device mesh) is not ported to bulklmm_tpu_torch yet "
            "(ROADMAP.md Queue 1 item 14, multi-GPU)"
        )
