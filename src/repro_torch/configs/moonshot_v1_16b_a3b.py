"""moonshot-v1-16b-a3b [moe]: kimi/moonlight-style, 64 experts top-6
[hf:moonshotai/Moonlight-16B-A3B]."""
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe", n_layers=48, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1408, vocab_size=163840, head_dim=128,
    mlp_kind="swiglu", n_experts=64, top_k=6,
    block_pattern=("attn_moe",),
    source="hf:moonshotai/Moonlight-16B-A3B")
