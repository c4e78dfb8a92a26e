"""The distributed runtime (counterpart of ``repro.runtime``): int8
error-feedback gradient compression, elastic remeshing and restore, the
GPipe pipeline, and fault tolerance (the straggler monitor, the retry
wrapper and heartbeats)."""

from .compression import (
    dequantize_int8,
    ef_compress,
    init_error_state,
    make_compressed_mean,
    quantize_int8,
)
from .elastic import MeshPlan, build_mesh, elastic_restore, remesh_plan
from .fault import Heartbeat, StragglerMonitor, with_retries
from .pipeline import bubble_fraction, pipeline_run

__all__ = ["Heartbeat", "MeshPlan", "StragglerMonitor", "bubble_fraction",
           "build_mesh", "dequantize_int8", "ef_compress", "elastic_restore",
           "init_error_state", "make_compressed_mean", "pipeline_run",
           "quantize_int8", "remesh_plan", "with_retries"]
