from .mesh import device_mesh
from .step import make_pipeline_step, dryrun_step
