"""Strips between processes: gloo ``isend``/``irecv`` through host buffers.

The port's counterpart of the reference's ghost-ring ``Isend/Irecv``
(``mpi/mpi_convolution.c:156-192``) for a mesh whose tiles live in several
processes (:mod:`tpu_stencil_torch.parallel.mesh`). The exchange code
(:mod:`~tpu_stencil_torch.parallel.halo`, :mod:`~tpu_stencil_torch.
parallel.overlap`) copies a strip between two tiles of one process as
before; a strip whose two tiles have different owners goes through one
:class:`Batch` of this module:

* a strip that leaves a card is copied into a pinned host buffer on the
  current stream, and that copy's event is waited on by the host before
  the ``isend`` (gloo reads the buffer on its own thread);
* a received strip is copied back into its ghost band with
  ``non_blocking=True`` on the current stream, the stream K3 then runs
  on; the buffer is not handed to the next ``irecv`` before the event of
  that copy has completed;
* the host buffers are allocated once per (direction, peer, tag) and
  kept by :class:`Peers` for the run, like the slab.

gloo is the transport, asked for by name (:func:`distributed.initialize`):
it carries CPU tensors between processes on the CPU and between processes
that share one card, where NCCL refuses two ranks on one device.

A batch posts every ``irecv`` before its ``isend``\\ s, then waits on all
of them; every wait takes the dispatch timeout and raises
:class:`~tpu_stencil_torch.resilience.errors.DispatchTimeout` past it (a
wedged peer blocks the host here, where the device watchdog does not
look). A tag names the receiving tile and its slot (:data:`SLOTS`: the
edge, or the corner hop's side), so two strips between one pair of ranks
never match each other's receive.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

# A receiving tile's slots: its four edge ghosts, and the two packed
# corner payloads of the second hop (from its west and east neighbours).
SLOTS = {"n": 0, "s": 1, "w": 2, "e": 3, "corners_w": 4, "corners_e": 5}


class _Staging:
    """One host buffer and the event of the last copy that used it."""

    __slots__ = ("host", "event")

    def __init__(self, host: torch.Tensor) -> None:
        self.host = host
        self.event: Optional[torch.cuda.Event] = None


def _record(dev: torch.device) -> Optional[torch.cuda.Event]:
    if dev.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(dev))
    return ev


class Peers:
    """The owner rank of every tile of a mesh that spans several
    processes, the dispatch timeout each wait takes (0: gloo's own), and
    the host buffers of the run.

    :attr:`bytes_staged` counts every byte sent or received so far."""

    def __init__(self, owners: Sequence[Sequence[int]],
                 timeout_s: float = 0.0) -> None:
        self.owners = tuple(tuple(row) for row in owners)
        self.timeout_s = timeout_s
        self.grid = (len(self.owners), len(self.owners[0]))
        self.bytes_staged = 0
        self._staging: Dict[tuple, _Staging] = {}

    def tag(self, i: int, j: int, slot: str) -> int:
        return (i * self.grid[1] + j) * len(SLOTS) + SLOTS[slot]

    def batch(self, label: str) -> "Batch":
        return Batch(self, label)

    def staging(self, kind: str, peer: int, tag: int,
                like: torch.Tensor) -> _Staging:
        """The host buffer of (``kind``, ``peer``, ``tag``) shaped like
        ``like``: pinned when ``like`` lies on a card."""
        key = (kind, peer, tag, tuple(like.shape), like.dtype)
        st = self._staging.get(key)
        if st is None:
            st = self._staging[key] = _Staging(torch.empty(
                like.shape, dtype=like.dtype,
                pin_memory=like.device.type == "cuda"))
        return st


class Batch:
    """The strips of one exchange step between this process and its
    peers: :meth:`send` and :meth:`recv` stage them, :meth:`run` moves
    them all and lands the received ones in their ghost bands."""

    def __init__(self, peers: Peers, label: str) -> None:
        self.peers = peers
        self.label = label
        self._sends: List[Tuple[int, int, _Staging]] = []
        self._recvs: List[Tuple[int, int, _Staging, torch.Tensor]] = []

    def send(self, to: Tuple[int, int], slot: str,
             strip: torch.Tensor) -> None:
        """Send ``strip`` (a view of a local tile) to slot ``slot`` of
        the remote tile ``to``: copied into its host buffer now, on the
        current stream."""
        peer = self.peers.owners[to[0]][to[1]]
        tag = self.peers.tag(to[0], to[1], slot)
        st = self.peers.staging("send", peer, tag, strip)
        st.host.copy_(strip, non_blocking=st.host.is_pinned())
        st.event = _record(strip.device)
        self._sends.append((peer, tag, st))

    def recv(self, into: Tuple[int, int], slot: str,
             frm: Tuple[int, int], dst: torch.Tensor) -> None:
        """Receive slot ``slot`` of the local tile ``into`` from the
        remote tile ``frm`` into ``dst`` (a view of the ghost band)."""
        peer = self.peers.owners[frm[0]][frm[1]]
        tag = self.peers.tag(into[0], into[1], slot)
        st = self.peers.staging("recv", peer, tag, dst)
        self._recvs.append((peer, tag, st, dst))

    def run(self) -> None:
        """Post every receive, then every send, wait on all of them, then
        copy each received strip into its ghost band on the current
        stream."""
        import torch.distributed as dist

        from tpu_stencil_torch.parallel import distributed

        works = []
        for peer, tag, st, _ in self._recvs:
            if st.event is not None:
                st.event.synchronize()  # its last H2D copy has landed
            works.append(dist.irecv(st.host, src=peer, tag=tag))
        for peer, tag, st in self._sends:
            if st.event is not None:
                st.event.synchronize()  # the D2H copy gloo will read
            works.append(dist.isend(st.host, dst=peer, tag=tag))
        for w in works:
            distributed.wait(w, self.peers.timeout_s, self.label)
        for _, _, st, dst in self._recvs:
            dst.copy_(st.host, non_blocking=st.host.is_pinned())
            st.event = _record(dst.device)
        self.peers.bytes_staged += sum(
            st.host.nbytes for *_, st in self._sends) + sum(
            st.host.nbytes for _, _, st, _ in self._recvs)
