"""Serving (port of ``repro.serving``): the wave, continuous and paged
engines and fault-tolerant swarm serving."""
from repro_torch.serving.engine import (ContinuousEngine, Request,
                                        WaveEngine, make_engine)
from repro_torch.serving.paging import (BlockPool, BlockPoolExhaustedError,
                                        PagedEngine, PrefixIndex,
                                        build_paged_cache, chain_digests,
                                        paged_cache_from_template)
from repro_torch.serving.swarm_serve import (ReplayBudgetError,
                                             StageRPCError, StageServer,
                                             StageUnservableError,
                                             SwarmRouter, publish_stages,
                                             restore_stage_params,
                                             stage_chunk_id)

__all__ = ["Request", "WaveEngine", "ContinuousEngine", "make_engine",
           "PagedEngine", "BlockPool", "BlockPoolExhaustedError",
           "PrefixIndex", "build_paged_cache", "chain_digests",
           "paged_cache_from_template",
           "StageServer", "SwarmRouter", "publish_stages",
           "restore_stage_params", "stage_chunk_id",
           "StageUnservableError", "ReplayBudgetError", "StageRPCError"]
