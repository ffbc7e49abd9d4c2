from .pipeline import (BlockTiming, DagPipelineExecutor, PipelineExecutor,
                       Stage, StageTiming)
from .ft import (HeartbeatRegistry, ShardAssignment, StragglerDetector,
                 TrainSupervisor)

__all__ = ["BlockTiming", "DagPipelineExecutor", "PipelineExecutor", "Stage",
           "StageTiming", "HeartbeatRegistry", "ShardAssignment",
           "StragglerDetector", "TrainSupervisor"]
