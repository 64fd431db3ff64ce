"""Networking: req/resp + gossip over a TCP wire, peer management.

Reference surface: packages/beacon-node/src/network/ (network.ts:41,
reqresp/reqResp.ts:45, gossip/gossipsub.ts:84, peers/peerManager.ts:105).
The v1 transport is TCP loopback/LAN with ssz_snappy payload framing —
the protocol semantics (method set, status handshake, IGNORE/REJECT
gossip flow, range sync batching) match the reference; the libp2p
multistream/noise layers are out of scope for this milestone and isolated
behind the Wire class so a discv5/libp2p transport can slot in.
"""

from .network import Network  # noqa: F401
from .peer import PeerManager  # noqa: F401
