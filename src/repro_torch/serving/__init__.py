from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.perllm_server import PerLLMServer, ServedRequest
from repro_torch.serving.sampling import sample_tokens

__all__ = ["PerLLMServer", "Request", "ServedRequest", "ServingEngine",
           "sample_tokens"]
