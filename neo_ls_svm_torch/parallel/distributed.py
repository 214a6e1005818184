"""Multi-process set-up: the process group and a host-major mesh.

PyTorch port of ``neo_ls_svm_tpu.parallel.distributed``. One process drives one GPU; a
launcher such as ``torchrun --nproc-per-node=N`` starts the processes, numbers them host
by host and exports ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``. Each process calls
:func:`initialize_distributed` once, then builds its mesh (:func:`make_multihost_mesh` or
``parallel.mesh.make_mesh``) and fits with ``NeoLSSVM(mesh=...)`` on the full data.
"""

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from neo_ls_svm_torch.parallel.mesh import make_mesh


def initialize_distributed(
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    backend: str | None = None,
) -> bool:
    """Initialise the default process group; returns True if it did anything.

    With every argument None it does nothing, so library code may call it
    unconditionally; under ``torchrun`` pass ``init_method="env://"`` (world size and rank
    then come from the environment). Idempotent: it consults ``dist.is_initialized()``,
    so a group the caller made with ``torch.distributed.init_process_group`` counts too.
    The backend is ``"nccl"`` when CUDA is available and ``"gloo"`` otherwise, unless
    ``backend`` names one. A CUDA process first selects the GPU ``LOCAL_RANK`` names.
    """
    if dist.is_initialized():
        return False
    if all(v is None for v in (init_method, world_size, rank, backend)):
        return False
    cuda = torch.cuda.is_available()
    if cuda and "LOCAL_RANK" in os.environ:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    kwargs = {k: v for k, v in (("world_size", world_size), ("rank", rank)) if v is not None}
    dist.init_process_group(
        backend=backend or ("nccl" if cuda else "gloo"),
        init_method=init_method,
        **kwargs,
    )
    return True


def make_multihost_mesh(num_feature: int = 1, device_type: str = "cuda") -> DeviceMesh:
    """A ("data", "feature") mesh whose ``feature`` groups stay within one host.

    ``torchrun`` numbers ranks host by host, so the row-major mesh of
    :func:`~neo_ls_svm_torch.parallel.mesh.make_mesh` puts each ``feature`` group (the
    per-chunk sums) on consecutive ranks of one host, and the ``data`` axis (one Gram
    sum a fit) across hosts. The hosts must hold equal numbers of ranks
    (``LOCAL_WORLD_SIZE``, all ranks on one host when unset), divisible by ``num_feature``.
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % per_host:
        msg = (
            f"{world} ranks spread unevenly over hosts of {per_host} ranks "
            "(LOCAL_WORLD_SIZE); start the same number of ranks on every host."
        )
        raise ValueError(msg)
    if per_host % num_feature:
        msg = (
            f"per-host rank count {per_host} is not divisible by "
            f"num_feature={num_feature}; choose a feature-axis size that divides it."
        )
        raise ValueError(msg)
    return make_mesh(num_feature=num_feature, device_type=device_type)
