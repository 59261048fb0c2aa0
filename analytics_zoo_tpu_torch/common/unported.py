"""Arguments of the JAX surface whose machinery is not ported yet.

A ported name takes every argument of the JAX name it ports.  Where the
machinery behind an argument is not ported, passing it raises
``NotImplementedError`` naming the ROADMAP item that ports it; leaving it
at its JAX default runs as before.
"""

from __future__ import annotations

from typing import Optional

#: ROADMAP Queue 1 items, by the number the messages cite
QUEUE_ITEMS = {
    1: "ROADMAP Queue 1 item 1: server-side image decode",
    2: "ROADMAP Queue 1 item 2: the rest of training, with the "
       "TrainConfig fields failure_retry_window_sec, donate_state and "
       "rng_impl, and loading a KerasNet file the JAX package wrote",
    5: "ROADMAP Queue 1 item 5: the rest of parallel/, a job whose "
       "processes hold unequal, overlapping or non-contiguous ranges of "
       "data coordinates",
    6: "ROADMAP Queue 1 item 6: the rest, with net/ (torch.optim and "
       "tf.keras optimizer conversion), feature/, the rest of tfpark/ "
       "and InferenceSummary",
}


def reject(where: str, item: int, defaults: Optional[dict] = None,
           **args) -> None:
    """Raise ``NotImplementedError`` for the first of ``args`` that is not
    at its JAX default (``defaults[name]`` where given, else ``None``),
    naming ``where`` and Queue 1 item ``item``."""
    defaults = defaults or {}
    for name, value in args.items():
        changed = (value != defaults[name] if name in defaults
                   else value is not None)
        if changed:
            raise NotImplementedError(
                f"{where}({name}=...) is not ported yet "
                f"({QUEUE_ITEMS[item]})")
