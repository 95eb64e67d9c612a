"""PipelineParallel (parity: fleet/meta_parallel/pipeline_parallel.py) —
not ported yet: the pipeline schedules are ROADMAP A10.3."""
from __future__ import annotations

__all__ = ["PipelineParallel"]


class PipelineParallel:
    def __init__(self, layers, hcg=None, strategy=None):
        raise NotImplementedError(
            "fleet.meta_parallel.PipelineParallel (pipeline schedules over "
            "the 'pp' axis) is not ported yet (ROADMAP A10.3)")
