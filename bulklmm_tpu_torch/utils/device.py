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


def mesh_device(mesh, device):
    """The device a call with ``mesh=`` runs from: the mesh's first device
    (where its inputs are prepared and its results assembled), or ``device``
    without a mesh. Refuses a ``device`` that names another one."""
    if mesh is None:
        return device
    if device is not None and torch.device(device) != mesh.first:
        raise ValueError(
            f"device={device} and mesh= disagree: a call on a mesh runs from the mesh's "
            f"first device ({mesh.first}); drop device="
        )
    return mesh.first
