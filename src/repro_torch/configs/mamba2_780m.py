"""mamba2-780m [ssm]: 48L d=1536 (attention-free) vocab=50280
ssm_state=128 — SSD / state-space duality [arXiv:2405.21060; unverified]."""
from repro_torch.utils.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m", family="ssm", num_layers=48, d_model=1536,
        num_heads=24, num_kv_heads=24, d_ff=0, vocab_size=50280,
        head_dim=64, ssm_state=128, ssm_head_dim=64, ssm_expand=2)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m-smoke", family="ssm", num_layers=3, d_model=64,
        num_heads=4, num_kv_heads=4, d_ff=0, vocab_size=256, head_dim=16,
        ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_chunk=16)
