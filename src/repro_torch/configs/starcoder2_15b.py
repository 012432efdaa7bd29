"""starcoder2-15b [dense]: 40L d=6144 48H (GQA kv=4) ff=24576 vocab=49152.
GQA + RoPE [arXiv:2402.19173; hf]."""
from repro_torch.utils.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b", family="dense", num_layers=40, d_model=6144,
        num_heads=48, num_kv_heads=4, d_ff=24576, vocab_size=49152,
        head_dim=128, rope_theta=100_000.0)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b-smoke", family="dense", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
        rope_theta=100_000.0)
