from .pipeline import (BlockTiming, DagPipelineExecutor, PipelineExecutor,
                       Stage, StageTiming)

__all__ = ["BlockTiming", "DagPipelineExecutor", "PipelineExecutor", "Stage",
           "StageTiming"]
