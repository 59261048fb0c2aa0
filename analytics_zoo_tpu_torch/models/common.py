"""ZooModel: a functional-graph model with a domain API on top.

Port of ``ZooModel`` in ``analytics_zoo_tpu/models/common.py``.  ``Ranker``
waits for the text-matching model it serves (``KNRM``, ROADMAP Queue 1
item 2); ``save`` / ``load`` are ``KerasNet``'s.
"""

from __future__ import annotations

from analytics_zoo_tpu_torch.keras.engine import Model


class ZooModel(Model):
    """Subclasses build their graph and call ``super().__init__`` with its
    inputs and outputs (and ``device=``, default the card)."""

    def summary(self) -> str:
        """Parameter counts by layer (trainable parameters, as the JAX
        package counts its params tree), in graph order."""
        lines = [f"Model: {type(self).__name__}"]
        total = 0
        for layer in dict.fromkeys(self.layers):
            n = layer.param_count()
            if n:
                total += n
                lines.append(f"  {layer.name}: {n:,} params")
        lines.append(f"Total params: {total:,}")
        return "\n".join(lines)
