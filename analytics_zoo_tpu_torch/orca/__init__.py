"""Orca: the worker-process launcher (``RayContext``).

Port of ``analytics_zoo_tpu/orca``'s launcher; ``XShards`` and
``orca/learn.py`` are ROADMAP Queue 1 item 6.
"""

from analytics_zoo_tpu_torch.orca.ray import RayContext  # noqa: F401

__all__ = ["RayContext"]
