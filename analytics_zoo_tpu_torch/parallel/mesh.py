"""A named grid of devices: the port's counterpart of ``jax.sharding.Mesh``.

The JAX package is single-controller: one program runs a ``shard_map``
over a ``Mesh`` of devices.  The port keeps that model without
``torch.distributed``: one process holds every shard and places each on
the device at its mesh coordinate.  A device may appear more than once
(``Mesh(["cuda:0"] * 4, ("sequence",))`` runs four shards on one card,
``["cpu"] * 8`` eight on the host), the counterpart of XLA's virtual host
devices; moving a shard to a device it is already on costs nothing.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch


class Mesh:
    """``devices``: a nested sequence (or object array) of devices or device
    strings, one dimension per name in ``axis_names``."""

    def __init__(self, devices, axis_names: Sequence[str]):
        raw = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if raw.ndim != len(axis_names):
            raise ValueError(f"a mesh of {raw.ndim} dimension(s) "
                             f"{raw.shape} needs as many axis names, got "
                             f"{axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"axis names must differ, got {axis_names}")
        flat = np.empty(raw.size, dtype=object)
        flat[:] = [torch.device(d) for d in raw.flat]
        self.devices = flat.reshape(raw.shape)
        self.axis_names = axis_names

    @property
    def shape(self) -> Dict[str, int]:
        """``{axis name: size}`` in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def device(self, coords: Mapping[str, int]) -> torch.device:
        """The device at ``coords`` (``{axis name: index}``); an axis left
        out is taken at index 0."""
        unknown = set(coords) - set(self.axis_names)
        if unknown:
            raise ValueError(f"no mesh axis {sorted(unknown)}; axes are "
                             f"{self.axis_names}")
        return self.devices[tuple(coords.get(a, 0) for a in self.axis_names)]

    def __repr__(self):
        devices = sorted({str(d) for d in self.devices.flat})
        return f"Mesh({self.shape}, devices={devices})"
