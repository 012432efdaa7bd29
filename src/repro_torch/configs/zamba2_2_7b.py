"""zamba2-2.7b [hybrid]: 54L d=2560 32H (GQA kv=32) ff=10240 ssm_state=64.
Mamba2 backbone + one shared attention block applied every 6 layers
[arXiv:2411.15242; hf].  Simplification vs released weights: the shared
block sees the hidden stream only (no concat with the embedding stream);
recorded in DESIGN.md."""
from repro_torch.utils.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b", family="hybrid", num_layers=54, d_model=2560,
        num_heads=32, num_kv_heads=32, d_ff=10240, vocab_size=32000,
        head_dim=80, ssm_state=64, ssm_head_dim=64, ssm_expand=2,
        hybrid_attn_every=6)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b-smoke", family="hybrid", num_layers=4, d_model=64,
        num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=256, head_dim=16,
        ssm_state=16, ssm_head_dim=16, ssm_expand=2, hybrid_attn_every=2,
        ssm_chunk=16)
