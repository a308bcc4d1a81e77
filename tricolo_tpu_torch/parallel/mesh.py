"""The 1-D data mesh that parameter sharding places tensors on.

Port of ``tricolo_tpu.parallel.mesh``'s mesh. The JAX package's data axis
spans every device; the port's spans the processes of its ``World``, one
GPU each (``parallel/world.py``). The replicated path needs no more than
the world's process group. ``parallel.param_sharding=fsdp`` needs the
group as a ``DeviceMesh``, since PyTorch's FSDP (``fully_shard``) and its
``DTensor`` parameters take one: a 1-D mesh named ``"data"`` over the
world's group, on the device type of the rank's device.
"""

from __future__ import annotations

from .multiprocess import World

DATA_AXIS = "data"


def data_mesh(world: World, device_type: str):
    """The 1-D ``DeviceMesh`` named ``DATA_AXIS`` over ``world``'s group."""
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh.from_group(world.group, device_type, mesh_dim_names=(DATA_AXIS,))
