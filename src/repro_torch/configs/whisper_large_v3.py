"""whisper-large-v3 [audio/enc-dec]: 32L d=1280 20H ff=5120 vocab=51866.
Conv frontend is a STUB (input_specs provides precomputed frame embeddings)
[arXiv:2212.04356; unverified].  Positional stub: RoPE instead of Whisper's
sinusoidal/learned-absolute embeddings (recorded in DESIGN.md)."""
from repro_torch.utils.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3", family="encdec", num_layers=32, d_model=1280,
        num_heads=20, num_kv_heads=20, d_ff=5120, vocab_size=51866,
        head_dim=64, num_encoder_layers=32)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3-smoke", family="encdec", num_layers=2,
        d_model=64, num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=256,
        head_dim=16, num_encoder_layers=2)
