"""llama-3.2-vision-90b [vlm]: 100L d=8192 64H (GQA kv=8) ff=28672
vocab=128256; gated cross-attn image layers every 5th layer
[hf:meta-llama/Llama-3.2-11B-Vision; unverified].  Vision tower is a STUB
(input_specs provides patch embeddings)."""
from repro_torch.utils.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b", family="vlm", num_layers=100,
        d_model=8192, num_heads=64, num_kv_heads=8, d_ff=28672,
        vocab_size=128256, head_dim=128, rope_theta=500_000.0,
        cross_attn_every=5, num_image_tokens=1024)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b-smoke", family="vlm", num_layers=4,
        d_model=64, num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
        head_dim=16, cross_attn_every=2, num_image_tokens=8)
