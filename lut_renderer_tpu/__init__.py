"""lut_renderer_tpu — accelerated batch video 3D-LUT color pipeline.

A ground-up JAX/XLA rebuild of the capabilities of ionlz/LUT-renderer
(reference mounted at /root/reference). The reference delegates every pixel to an
external FFmpeg process (reference: src/lut_renderer/ffmpeg.py:179-487 builds argv;
src/lut_renderer/task_manager.py:145-151 runs it). This framework replaces that
native pixel path with a fused compute path on the accelerator:

    decode (host, libav/cv2) -> planar YUV batches -> device memory
      -> one jitted step: range normalize -> YUV->RGB matrix -> 3D LUT
         (tetrahedral/trilinear/nearest) -> RGB->YUV -> dither -> quantize
      -> host encode (prores_ks / available encoders)

around which sit the same policy engine, task queue, presets/settings persistence,
and output-naming contract as the reference.

Layering (bottom-up):
  colorcore  pure color math + .cube parsing + NumPy/JAX reference interpolators
  ops        the jitted device pixel pipeline (XLA)
  hostio     native media layer (probe/decode/encode) over bundled FFmpeg libs
  models     data model (Task, ProcessingParams, VideoInfo, TaskStatus)
  plan       policy engine: ProcessingParams -> RenderPlan stages (pure, testable)
  engine     streaming executor: decode -> H2D -> render -> encode, double-buffered
  parallel   multi-device frame sharding over a jax.sharding.Mesh
  tasks      task queue/scheduler (reference TaskManager semantics, callback-based)
  app        CLI, presets, settings, thumbnails, naming
"""

__version__ = "0.1.0"
