"""engine — the streaming executor: decode -> device render -> encode.

This is the rebuild's replacement for the hot loop the reference runs
inside an external FFmpeg process (reference: src/lut_renderer/
task_manager.py:145-178 reads FFmpeg stderr while the native binary does the
pixels). Here the stages are explicit and pipelined: a decode thread fills a
bounded queue of frame batches, the main thread drives the jitted device render
function (dispatch is async, so device compute overlaps host decode), and an
encode thread drains results in order.
"""

from .config import derive_render_config, derive_encoder_settings
from .scheduler import FrameScheduler
from .executor import StageResult, run_stage, StageStats

__all__ = [
    "derive_render_config",
    "derive_encoder_settings",
    "FrameScheduler",
    "StageResult",
    "StageStats",
    "run_stage",
]
