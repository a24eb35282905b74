"""Checkpointing and live recovery (port of ``repro.checkpointing``):
flat checkpoints, the content-addressed chunk store, int8/int4 delta
chains (replayed through the codec kernels on CUDA), async snapshots,
P2P and swarm fetch, chunk gossip and the streaming join."""
from repro_torch.checkpointing.checkpoint import (latest_step, restore, save,
                                            save_async)
from repro_torch.checkpointing.delta import (ChainReplayer, DeltaCheckpointer,
                                       DeltaConfig, DeltaChainError)
from repro_torch.checkpointing.gossip import (ChunkGossip, socket_transport,
                                        store_transport)
from repro_torch.checkpointing.p2p import (CheckpointServer, ChecksumError,
                                     EmptyPeerError, FetchError,
                                     PeerClosedError, PeerConn,
                                     PeerConnPool, PeerTimeoutError,
                                     RetryDeadlineError, RetryPolicy,
                                     RetryableFetchError,
                                     fetch_checkpoint, retry_call)
from repro_torch.checkpointing.snapshot import AsyncSnapshotter
from repro_torch.checkpointing.store import (ChunkCorruptError,
                                       ChunkMissingError, ChunkStore)
from repro_torch.checkpointing.streaming import StreamingFetcher
from repro_torch.checkpointing.swarm import (ChunkPeer, NoPeersError,
                                       StepRetiredError, SwarmFetchError,
                                       recover, swarm_fetch)

__all__ = [
    "save", "save_async", "restore", "latest_step",
    "CheckpointServer", "fetch_checkpoint", "PeerConn", "PeerConnPool",
    "FetchError", "PeerClosedError", "ChecksumError", "EmptyPeerError",
    "RetryableFetchError", "PeerTimeoutError", "RetryDeadlineError",
    "RetryPolicy", "retry_call",
    "ChunkStore", "ChunkCorruptError", "ChunkMissingError",
    "DeltaCheckpointer", "DeltaConfig", "DeltaChainError",
    "ChainReplayer",
    "ChunkPeer", "swarm_fetch", "recover", "SwarmFetchError",
    "NoPeersError", "StepRetiredError",
    "ChunkGossip", "socket_transport", "store_transport",
    "StreamingFetcher",
    "AsyncSnapshotter",
]
