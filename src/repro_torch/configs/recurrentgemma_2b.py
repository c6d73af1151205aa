"""recurrentgemma-2b [hybrid]: RG-LRU + local attention, 2 recurrent : 1
attention (Griffin) [arXiv:2402.19427]. Sub-quadratic -> runs long_500k."""
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid", n_layers=26, d_model=2560,
    n_heads=10, n_kv_heads=1, d_ff=7680, vocab_size=256000, head_dim=256,
    mlp_kind="geglu", block_pattern=("rglru", "rglru", "attn_local"),
    attn_window=2048, tie_embeddings=True, embed_scale=True,
    sub_quadratic=True,
    source="arXiv:2402.19427; hf:google/recurrentgemma-2b")
