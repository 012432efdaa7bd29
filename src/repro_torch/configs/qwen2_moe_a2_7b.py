"""qwen2-moe-a2.7b [moe]: 24L d=2048 16H (GQA kv=16) ff=1408/expert
vocab=151936; 60 routed top-4 + 4 shared experts (shared ff = 5632)
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]."""
from repro_torch.utils.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b", family="moe", num_layers=24, d_model=2048,
        num_heads=16, num_kv_heads=16, d_ff=1408, vocab_size=151936,
        head_dim=128, num_experts=60, experts_per_token=4,
        num_shared_experts=4, shared_expert_d_ff=5632)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b-smoke", family="moe", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, d_ff=64, vocab_size=256, head_dim=16,
        num_experts=6, experts_per_token=2, num_shared_experts=2,
        shared_expert_d_ff=128)
