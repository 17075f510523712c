from .matting import MattingPipeline, PipelineOptions  # noqa: F401
