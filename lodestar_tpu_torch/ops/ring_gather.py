"""The ring all-gather of the sharded tier: every shard's chunk to every
shard, in original shard order.

The port of ``lodestar_tpu/ops/pallas_ring.py``, whose ``ring_all_gather``
is elementwise identical to ``lax.all_gather`` inside ``shard_map``; here
it serves both that gather and the ``ppermute`` ring of
``ops/sharded_verify.py``.  The schedule is ``_ring_gather_kernel``'s:

- a seed copy of shard s's chunk into slot s of its own output;
- n - 1 hops: at hop k, shard s pushes slot (s - k) mod n into the same
  slot of its right neighbour (s + 1) mod n.

A shard is a (device, stream) pair, and one card may hold several
(logical shards, as the JAX package's tests use virtual CPU devices).  On
the card every copy, seed and hop alike, is one launch of the hand-written
``ring_hop_k`` (``kernels/ring_kernels.cu``) on the sending shard's stream,
through a peer pointer when the neighbour is another card.  The order
across shards lives in CUDA events: hop k on shard s waits for hop k - 1
on shard s - 1 (the chunk it forwards landed then) and, before its first
hop, for shard s + 1's "buffer ready" event (recorded after that shard
allocated its output and seeded it); each shard's stream ends waiting for
the last hop of shard s - 1, so whatever it runs next reads a full stack.

Inside a CUDA graph (the sharded tier's combine, ``MeshProgram``) one
stream issues every copy, ``issuer``: shard 0's, whose capture holds
them.  The hops keep their order, and a copy between two other cards
goes through peer pointers from the issuer's card, enabled before the
capture (``enable_issuer_peers``); the caller gives the outputs, made
outside the capture, so that no allocation on another card is captured.

On the CPU the plain version (``ring_all_gather_plain``, the same hops as
``copy_``) runs; mixing CPU and CUDA chunks raises, and so does a pair of
distinct cards without peer access.  There is no fallback to ``copy_`` on
the card, and no NCCL: the port is one process driving every shard.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import torch

from .fused_core import LaunchCounter

#: the ring hop kernel's launch count (seeds and hops alike)
RING_HOP = LaunchCounter("ring_hop", "lodestar_tpu/ops/pallas_ring.py:93")

_peer_lock = threading.Lock()
_peers_enabled = set()


def _check(chunks: Sequence[torch.Tensor], out: Optional[Sequence[torch.Tensor]] = None) -> str:
    """Validate the chunks (and outputs); returns the device type, "cpu"
    or "cuda"."""
    if not chunks:
        raise ValueError("ring: no chunks")
    shape = tuple(chunks[0].shape)
    for c in chunks:
        if c.dtype != torch.float32:
            raise TypeError(f"ring: chunks must be float32, got {c.dtype}")
        if tuple(c.shape) != shape:
            raise ValueError(f"ring: chunk shapes differ: {shape} and {tuple(c.shape)}")
        if not c.is_contiguous():
            raise ValueError("ring: a chunk is not contiguous")
    types = {c.device.type for c in chunks}
    if len(types) != 1 or types.pop() not in ("cpu", "cuda"):
        raise ValueError(f"ring: chunks must all be on the CPU or all on CUDA devices, got "
                         f"{[str(c.device) for c in chunks]}")
    if out is not None:
        if len(out) != len(chunks):
            raise ValueError("ring: one output buffer per shard")
        want = (len(chunks),) + shape
        for c, o in zip(chunks, out):
            if o.dtype != torch.float32 or tuple(o.shape) != want or not o.is_contiguous():
                raise ValueError(f"ring: an output must be a contiguous float32 {want}")
            if o.device != c.device:
                raise ValueError("ring: an output lies on another device than its chunk")
    return chunks[0].device.type


def hop_order(n: int):
    """(hop k, sending shard s, slot) of the n - 1 hops, hop-major."""
    return [(k, s, (s - k) % n) for k in range(n - 1) for s in range(n)]


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def ring_all_gather_plain(chunks: Sequence[torch.Tensor], out: Sequence[torch.Tensor]):
    """``out[s][j] = chunks[j]`` for every shard s, written in the hop order
    of the kernel with ``copy_``."""
    n = len(chunks)
    for s in range(n):
        out[s][s].copy_(chunks[s])
    for _k, s, slot in hop_order(n):
        out[(s + 1) % n][slot].copy_(out[s][slot])
    return out


def ring_permute_plain(chunks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """One hop: shard s receives shard s - 1's chunk."""
    n = len(chunks)
    out = [torch.empty_like(c) for c in chunks]
    for s in range(n):
        out[(s + 1) % n].copy_(chunks[s])
    return out


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


def _enable_pairs(pairs) -> None:
    """Peer access from card a to card b for each (a, b); raises when two
    distinct cards cannot reach each other."""
    from .kernels import _build

    for a, b in pairs:
        if a == b or (a, b) in _peers_enabled:
            continue
        if not torch.cuda.can_device_access_peer(a, b):
            raise RuntimeError(f"ring: cuda:{a} has no peer access to cuda:{b}")
        with _peer_lock:
            rc = _build.load().ring_enable_peer(a, b)
            if rc != 0:
                raise RuntimeError(f"ring: enabling peer access cuda:{a} -> cuda:{b} failed: "
                                   f"cudaError {rc}")
            _peers_enabled.add((a, b))


def _enable_peers(devices: Sequence[torch.device]) -> None:
    """Peer access from each shard's card to its right neighbour's."""
    n = len(devices)
    _enable_pairs([(devices[s].index, devices[(s + 1) % n].index) for s in range(n)])


def enable_issuer_peers(issuer: torch.device, devices: Sequence[torch.device]) -> None:
    """Peer access from the issuing card to every shard's card, as a
    capture on the issuer's stream needs before it begins."""
    _enable_pairs([(issuer.index, d.index) for d in devices])


def launch_hop(src: torch.Tensor, dst: torch.Tensor, stream: torch.cuda.Stream) -> None:
    """One ring_hop_k launch on ``stream`` (the sender's, or the issuer's):
    src -> dst, both contiguous float32 of one size, on the stream's card
    or a peer's."""
    from .kernels import _build

    with torch.cuda.device(stream.device):
        rc = _build.load().launch_ring_hop(src.data_ptr(), dst.data_ptr(), src.numel(),
                                           stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"kernel ring_hop launch failed: cudaError {rc}")
    RING_HOP.count_launch()


def _streams(chunks, streams, issuer=None) -> List[torch.cuda.Stream]:
    if issuer is not None:
        if streams is not None:
            raise ValueError("ring: streams or an issuer, not both")
        _enable_pairs([(issuer.device.index, c.device.index) for c in chunks])
        return [issuer] * len(chunks)
    if streams is None:
        return [torch.cuda.current_stream(c.device) for c in chunks]
    if len(streams) != len(chunks):
        raise ValueError("ring: one stream per shard")
    for c, st in zip(chunks, streams):
        if st.device != c.device:
            raise ValueError("ring: a shard's stream lies on another device than its chunk")
    return list(streams)


def _record(stream: torch.cuda.Stream) -> torch.cuda.Event:
    ev = torch.cuda.Event()
    ev.record(stream)
    return ev


def ring_all_gather(chunks: Sequence[torch.Tensor], out: Optional[Sequence[torch.Tensor]] = None,
                    streams: Optional[Sequence[torch.cuda.Stream]] = None,
                    issuer: Optional[torch.cuda.Stream] = None) -> List[torch.Tensor]:
    """Every shard's chunk to every shard: ``out[s]`` becomes the (n, ...)
    stack of all chunks in shard order, on shard s's device.

    ``chunks[s]`` is shard s's float32 chunk, made on ``streams[s]`` (each
    device's current stream by default).  ``out`` (allocated here when
    None) holds one contiguous (n, ...) buffer per shard; when the caller
    gives it, it must have been made on the shard's stream.  On return each
    shard's stream is ordered after the whole gather.  ``issuer``: one
    stream that issues every copy in hop order (a graph's capture); then
    ``out`` is required."""
    if _check(chunks, out) == "cpu":
        if out is None:
            out = [c.new_empty((len(chunks),) + tuple(c.shape)) for c in chunks]
        return ring_all_gather_plain(chunks, out)
    n = len(chunks)
    if issuer is not None and out is None:
        raise ValueError("ring: an issuer needs the outputs made outside its capture")
    streams = _streams(chunks, streams, issuer)
    if issuer is None:
        _enable_peers([c.device for c in chunks])
    if out is None:
        out = []
        for c, st in zip(chunks, streams):
            with torch.cuda.stream(st):
                out.append(torch.empty((n,) + tuple(c.shape), dtype=torch.float32,
                                       device=c.device))
    ready = []
    for s in range(n):
        launch_hop(chunks[s], out[s][s], streams[s])  # the seed copy
        ready.append(_record(streams[s]))
    landed: List[torch.cuda.Event] = []
    for k, s, slot in hop_order(n):
        st = streams[s]
        right = (s + 1) % n
        if k == 0:
            st.wait_event(ready[right])
            if issuer is None:
                out[right].record_stream(st)
        else:
            st.wait_event(landed[(k - 1) * n + (s - 1) % n])
        launch_hop(out[s][slot], out[right][slot], st)
        landed.append(_record(st))
    if n > 1:
        for s in range(n):
            streams[s].wait_event(landed[(n - 2) * n + (s - 1) % n])
    return list(out)


def ring_permute(chunks: Sequence[torch.Tensor],
                 streams: Optional[Sequence[torch.cuda.Stream]] = None,
                 out: Optional[Sequence[torch.Tensor]] = None,
                 issuer: Optional[torch.cuda.Stream] = None) -> List[torch.Tensor]:
    """One hop of the ring (``lax.ppermute`` with the (s, s + 1) pairs):
    returns, per shard s, shard s - 1's chunk on shard s's device.  On
    return each shard's stream is ordered after the hop that fed it.
    ``out`` (one buffer per shard, like its chunk) and ``issuer`` as in
    ``ring_all_gather``."""
    if _check(chunks) == "cpu":
        return ring_permute_plain(chunks)
    n = len(chunks)
    if issuer is not None and out is None:
        raise ValueError("ring: an issuer needs the outputs made outside its capture")
    streams = _streams(chunks, streams, issuer)
    if issuer is None:
        _enable_peers([c.device for c in chunks])
    if out is None:
        out = []
        for c, st in zip(chunks, streams):
            with torch.cuda.stream(st):
                out.append(torch.empty_like(c))
    ready = [_record(st) for st in streams]
    done = []
    for s in range(n):
        st = streams[s]
        right = (s + 1) % n
        st.wait_event(ready[right])
        if issuer is None:
            out[right].record_stream(st)
        launch_hop(chunks[s], out[right], st)
        done.append(_record(st))
    for s in range(n):
        streams[s].wait_event(done[(s - 1) % n])
    return out
