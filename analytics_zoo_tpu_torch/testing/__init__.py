"""Test-support utilities that production code may hook into.

``analytics_zoo_tpu_torch.testing.chaos`` is the fault-injection harness
(a copy of ``analytics_zoo_tpu/testing/chaos.py``): production hot paths
call ``chaos.fire("<point>")``, which is
a single module-global read when no injector is installed.
"""
