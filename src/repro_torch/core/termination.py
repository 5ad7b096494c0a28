"""Termination detection for diffusive computations (PyTorch port of
``repro.core.termination``).

* :func:`quiescent` — counting detection for the batched engine:
  quiescence is exactly ``active == 0`` and ``in flight == 0``.
* :class:`DijkstraScholten` — the per-message Dijkstra–Scholten detector
  of the paper's HPX-5 implementation (host side), kept for the event
  oracle.
"""

from __future__ import annotations

__all__ = ["quiescent", "DijkstraScholten"]


def quiescent(active_count, inflight_count):
    """Global quiescence predicate for the batched engine."""
    return (active_count == 0) & (inflight_count == 0)


class DijkstraScholten:
    """Classic Dijkstra–Scholten termination detection (host-side).

    Node 'environment' (-1) is the root that injects the initial diffusion
    messages.  Every computation message is acknowledged; the first message
    a disengaged node receives makes the sender its parent.  A node sends
    the ack to its parent only once it is passive and its own deficit is
    zero; when the root's deficit reaches zero, the computation has
    terminated.
    """

    ENV = -1

    def __init__(self, n_nodes: int):
        self.parent = [None] * n_nodes   # None = disengaged
        self.deficit = [0] * n_nodes     # unacked messages sent by each node
        self.env_deficit = 0
        self.acks = 0                    # ack message count

    def on_send(self, sender: int):  # analysis: allow(mutation): host-side Dijkstra-Scholten accountant, not an action body
        if sender == self.ENV:
            self.env_deficit += 1
        else:
            self.deficit[sender] += 1

    def on_receive(self, receiver: int, sender: int) -> bool:
        """True if the receiver should ack immediately (already engaged);
        False if the sender became the receiver's parent."""
        if self.parent[receiver] is None and self.deficit[receiver] == 0:
            self.parent[receiver] = sender
            return False
        self._ack(sender)
        return True

    def maybe_detach(self, node: int, is_active: bool):
        """Called when a node goes passive; collapses the tree if possible."""
        if (
            not is_active
            and self.parent[node] is not None
            and self.deficit[node] == 0
        ):
            p = self.parent[node]
            self.parent[node] = None
            self._ack(p)

    def _ack(self, node: int):
        self.acks += 1
        if node == self.ENV:
            self.env_deficit -= 1
        else:
            self.deficit[node] -= 1

    def terminated(self) -> bool:
        return self.env_deficit == 0

    def invariant_ok(self) -> bool:
        """Tree-consistency invariant: no negative deficits."""
        return all(d >= 0 for d in self.deficit) and self.env_deficit >= 0
