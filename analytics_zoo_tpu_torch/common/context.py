"""Device choice and the device mesh for the port's entry points.

Port of ``analytics_zoo_tpu/common/context.py``.  An entry point runs on
``cuda`` unless its caller names another device; with no card and no
device named it raises rather than run on the CPU.  ``init_zoo_context``
builds the device mesh (``parallel.mesh.Mesh``) by the JAX package's
rule, from a ``ZooConfig`` or from ``load_config``'s file, environment
and overrides.  Unlike the JAX package, the port keeps no process-wide
context: each call builds a new ``ZooContext`` and callers pass its mesh
on, as ``parallel.ring_attention`` takes its mesh.  ``data_sharding``,
``put``, ``device_scope`` and the multi-host bring-up are not ported
(ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.config import (
    MeshConfig, ZooConfig, load_config)
from analytics_zoo_tpu_torch.parallel.mesh import Mesh


class NoCudaDeviceError(RuntimeError):
    """No CUDA device is visible and the caller named no device."""


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the current CUDA
    device, and raises ``NoCudaDeviceError`` when there is none."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise NoCudaDeviceError(f"device {dev} asked for, but no CUDA "
                                    "device is visible")
        return dev
    if not torch.cuda.is_available():
        raise NoCudaDeviceError(
            "no CUDA device is visible; the port runs on the card by "
            "default. Pass device='cpu' to run the plain PyTorch versions "
            "on the CPU.")
    return torch.device("cuda", torch.cuda.current_device())


def _platform_devices(platform: Optional[str]) -> list:
    """The devices of a ``ZooConfig.platform``: every visible CUDA device
    for None, ``"cuda"`` or ``"gpu"``, the host for ``"cpu"``."""
    if platform == "cpu":
        return [torch.device("cpu")]
    if platform not in (None, "cuda", "gpu"):
        raise ValueError(f"platform {platform!r}: the port runs on "
                         "'cuda' (or 'gpu', or None: the card) or 'cpu'")
    resolve_device()
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


class ZooContext:
    """The config tree and the device mesh built from it."""

    def __init__(self, config: ZooConfig, mesh: Mesh):
        self.config = config
        self.mesh = mesh

    @property
    def num_devices(self) -> int:
        return self.mesh.size

    def axis_size(self, name: str) -> int:
        return self.mesh.shape.get(name, 1)

    def __repr__(self):
        return f"ZooContext(mesh={self.mesh!r})"


def _build_mesh(devices: Sequence[torch.device], mc: MeshConfig) -> Mesh:
    n = len(devices)
    sizes = {"data": mc.data, "model": mc.model, "sequence": mc.sequence,
             "expert": mc.expert, "pipeline": mc.pipeline}
    fixed = 1
    fill_axis = None
    for name in mc.axis_names:
        s = sizes[name]
        if s == -1:
            if fill_axis is not None:
                raise ValueError("only one mesh axis may be -1")
            fill_axis = name
        else:
            fixed *= s
    if fill_axis is not None:
        if n % fixed != 0:
            raise ValueError(f"{n} devices not divisible by fixed axes {fixed}")
        sizes[fill_axis] = n // fixed
    total = int(np.prod([sizes[a] for a in mc.axis_names]))
    if total != n:
        raise ValueError(f"mesh {sizes} does not cover {n} devices")
    shape = tuple(sizes[a] for a in mc.axis_names)
    flat = np.empty(n, dtype=object)
    flat[:] = list(devices)
    return Mesh(flat.reshape(shape), mc.axis_names)


def init_zoo_context(conf: Optional[ZooConfig] = None,
                     config_path: Optional[str] = None, *,
                     devices: Optional[Sequence] = None,
                     **overrides) -> ZooContext:
    """A context whose mesh lays ``devices`` out by ``cfg.mesh``.

    ``cfg`` is ``conf``, or else ``load_config(config_path,
    **overrides)``: defaults < json/yaml file < ``ZOO_TPU_*`` environment
    < overrides, as in the JAX package.

    ``devices`` defaults to the devices of ``cfg.platform``: every visible
    CUDA device for None, ``"cuda"`` or ``"gpu"`` (``NoCudaDeviceError``
    when there is none), the host for ``"cpu"``; any other platform
    raises ``ValueError``.  A caller may name devices, repeated as often
    as the mesh has shards: ``["cpu"] * 8`` runs an 8-shard mesh on the
    host (as the tests do), ``["cuda:0"] * 4`` four shards on one card.
    """
    cfg = conf or load_config(config_path, **overrides)
    if devices is None:
        devices = _platform_devices(cfg.platform)
    else:
        devices = [resolve_device(d) for d in devices]
    return ZooContext(cfg, _build_mesh(devices, cfg.mesh))
