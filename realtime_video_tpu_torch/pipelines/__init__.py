from realtime_video_tpu_torch.pipelines.bidirectional_diffusion_inference import (
    BidirectionalDiffusionInferencePipeline,
)
from realtime_video_tpu_torch.pipelines.bidirectional_inference import (
    BidirectionalInferencePipeline,
)
from realtime_video_tpu_torch.pipelines.causal_diffusion_inference import (
    CausalDiffusionInferencePipeline,
)
from realtime_video_tpu_torch.pipelines.causal_inference import CausalInferencePipeline

__all__ = [
    "BidirectionalDiffusionInferencePipeline",
    "BidirectionalInferencePipeline",
    "CausalDiffusionInferencePipeline",
    "CausalInferencePipeline",
]
