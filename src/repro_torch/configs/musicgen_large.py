"""musicgen-large [audio]: decoder-only transformer over EnCodec tokens
[arXiv:2306.05284]. The EnCodec frontend is a STUB: ``forward(embeds=)``
takes precomputed frame embeddings; vocab is the 2048-entry codebook."""
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio", n_layers=48, d_model=2048,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab_size=2048, head_dim=64,
    mlp_kind="swiglu", frontend="encodec_stub",
    source="arXiv:2306.05284; hf:facebook/musicgen-large")
