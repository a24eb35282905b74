"""Asynchronous decentralized RL tier (port of ``repro.rl``): rollout
workers feed a DiLoCo trainer through a staleness-windowed buffer; the
trainer publishes each outer-step anchor as a policy version over the
swarm chunk protocol (see docs/rl_rollout.md)."""
from repro_torch.rl.buffer import Rollout, RolloutBuffer, StalenessLedger
from repro_torch.rl.driver import RLConfig, RLDriver
from repro_torch.rl.grpo import (GRPOBatcher, GRPOModel, group_advantages,
                                 render_example, toy_low_token_reward)
from repro_torch.rl.policy_pub import (PolicyPeer, PolicyPublisher,
                                       PolicyRetiredError, tree_sha)
from repro_torch.rl.rollout import AdoptionShaMismatch, RolloutWorker

__all__ = [
    "Rollout", "RolloutBuffer", "StalenessLedger",
    "GRPOBatcher", "GRPOModel", "group_advantages", "render_example",
    "toy_low_token_reward",
    "PolicyPeer", "PolicyPublisher", "PolicyRetiredError", "tree_sha",
    "RolloutWorker", "AdoptionShaMismatch",
    "RLConfig", "RLDriver",
]
