"""internlm2-1.8b [dense]: 24L d=2048 16H (GQA kv=8) ff=8192 vocab=92544.
GQA [arXiv:2403.17297; hf]."""
from repro_torch.utils.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-1.8b", family="dense", num_layers=24, d_model=2048,
        num_heads=16, num_kv_heads=8, d_ff=8192, vocab_size=92544,
        head_dim=128, rope_theta=1_000_000.0)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-1.8b-smoke", family="dense", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=192, vocab_size=256, head_dim=16)
