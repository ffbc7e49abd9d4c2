from .pipeline import PipelineExecutor, Stage, StageTiming

__all__ = ["PipelineExecutor", "Stage", "StageTiming"]
