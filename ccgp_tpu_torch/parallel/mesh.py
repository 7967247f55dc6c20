"""Device meshes (port of `ccgp_tpu/parallel/mesh.py`).

The natural parallel axes of the combined-GP workload are batch axes:
MCMC chains, posterior draws, designs, hyperprior grid rows. A mesh here
is a (dp, mp) grid of `torch.device`s; the functions of
`parallel.sharded` split a leading batch axis over its devices, run each
shard on its device and gather the results on the first. There is no
compiler to insert collectives, so the split, the padding and the
gather are explicit.

By default a mesh spans the CUDA devices there are. An explicit
`devices=` list may repeat a device, as XLA's virtual host devices do:
`["cpu"] * 8` in the tests, `["cuda:0"] * 4` on one card. A repeated
device runs its shards one after another, through the same split, pad
and gather code as distinct devices.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch


class Mesh:
    """A (dp, mp) grid of devices; `shape` maps axis names to sizes, as
    `jax.sharding.Mesh.shape` does."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError("one axis name per mesh dimension")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device_list(self) -> list:
        """The devices in row-major order: shard i runs on entry i."""
        return list(self.devices.reshape(-1))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.device_list]})"


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("dp", "mp"),
              shape: Optional[Sequence[int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over the first n_devices devices: the CUDA devices there are,
    or the `devices` list given (entries may repeat). Asking for more CUDA
    devices than exist raises and names the count.

    The default factorization puts everything on 'dp', with 'mp' = 2 when
    the count is even and at least 4, as JAX's does."""
    if devices is None:
        count = torch.cuda.device_count()
        n = count if n_devices is None else int(n_devices)
        if n < 1 or n > count:
            raise RuntimeError(
                f"make_mesh: {n} CUDA device(s) asked for, {count} present "
                "(pass devices=[...] for a mesh over other devices, which "
                "may repeat one)")
        devs = [torch.device("cuda", i) for i in range(n)]
    else:
        devs = [torch.device(d) for d in devices]
        n = len(devs) if n_devices is None else int(n_devices)
        if n < 1 or n > len(devs):
            raise ValueError(f"make_mesh: {n} devices asked for, "
                             f"{len(devs)} given")
        devs = devs[:n]
    if shape is None:
        mp = 2 if n % 2 == 0 and n >= 4 else 1
        shape = (n // mp, mp)
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(tuple(shape)), axis_names)


class Sharding(NamedTuple):
    """Which mesh axes split a tensor's leading dimension (() = replicated),
    the counterpart of a `NamedSharding` with a `PartitionSpec`."""

    mesh: Mesh
    axes: tuple


def data_sharding(mesh: Mesh, axis: str = "dp") -> Sharding:
    """Shard the leading dimension over `axis`, replicate the rest."""
    return Sharding(mesh, (axis,))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())
