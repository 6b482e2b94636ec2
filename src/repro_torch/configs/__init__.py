"""The reference's ten LLM architecture configs: the four dense ones, the
two MoE ones (qwen2-moe-a2.7b, and mixtral-8x22b with its sliding-window
KV ring), the encoder-decoder one (whisper-medium), the SSM one
(mamba2-1.3b), the hybrid one (recurrentgemma-9b) and the vlm one
(llama-3.2-vision-90b).  ``get_config(name)`` is the registry entry
point."""
from repro_torch.configs.base import (ArchConfig, get_config, register,
                                      list_archs, SHAPES, ShapeSpec)

# import for registration side effects
from repro_torch.configs import (  # noqa: F401
    starcoder2_3b, mistral_nemo_12b, internlm2_20b, qwen1_5_32b,
    qwen2_moe_a2_7b, mixtral_8x22b, whisper_medium, mamba2_1_3b,
    recurrentgemma_9b, llama3_2_vision_90b)

__all__ = ["ArchConfig", "get_config", "register", "list_archs", "SHAPES",
           "ShapeSpec"]
