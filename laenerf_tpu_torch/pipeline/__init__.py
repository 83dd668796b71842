from .driver import (EditPipeline, PipelineConfig, project_points,
                     run_npr_pipeline)
from .viewer import OrbitCamera, EditSession, launch_gui
