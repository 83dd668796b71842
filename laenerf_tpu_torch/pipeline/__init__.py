from .driver import EditPipeline, PipelineConfig, project_points
