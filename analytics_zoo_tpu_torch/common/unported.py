"""Arguments of the JAX surface whose machinery is not ported yet.

A ported name takes every argument of the JAX name it ports.  Where the
machinery behind an argument is not ported, passing it raises
``NotImplementedError`` naming the ROADMAP item that ports it; leaving it
at its default (``None``) runs as before.
"""

from __future__ import annotations

#: ROADMAP Queue 1 items, by the number the messages cite
QUEUE_ITEMS = {
    1: "ROADMAP Queue 1 item 1: pipelined serving, with multi-model "
       "routing, tenancy and reservations",
    6: "ROADMAP Queue 1 item 6: observability, with trace context and "
       "trace events",
}


def reject(where: str, item: int, **args) -> None:
    """Raise ``NotImplementedError`` for the first of ``args`` that is not
    ``None``, naming ``where`` and Queue 1 item ``item``."""
    for name, value in args.items():
        if value is not None:
            raise NotImplementedError(
                f"{where}({name}=...) is not ported yet "
                f"({QUEUE_ITEMS[item]})")
