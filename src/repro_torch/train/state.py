"""Training state trees (port of ``repro.train.state``)."""
from __future__ import annotations

from typing import Any, NamedTuple

from repro_torch.core.diloco import OuterState
from repro_torch.optim.adamw import AdamWState


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


class DiLoCoTrainState(NamedTuple):
    """Stacked (leading DiLoCo-worker dim) inner state + shared outer."""
    inner: TrainState
    outer: OuterState
