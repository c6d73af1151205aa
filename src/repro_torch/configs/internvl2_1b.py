"""internvl2-1b [vlm]: InternViT frontend (STUB) + Qwen2-0.5B-style
backbone [arXiv:2404.16821]. ``forward(embeds=)`` takes precomputed
patch embeddings; the transformer backbone below is the modeled compute."""
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm", n_layers=24, d_model=896, n_heads=14,
    n_kv_heads=2, d_ff=4864, vocab_size=151655, head_dim=64,
    mlp_kind="swiglu", frontend="vit_stub", tie_embeddings=True,
    rope_theta=1_000_000.0,
    source="arXiv:2404.16821; hf:OpenGVLab/InternVL2-1B")
