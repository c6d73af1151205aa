"""xlstm-350m [ssm]: sLSTM + mLSTM blocks, [7:1] ratio [arXiv:2405.04517;
unverified]. d_ff=0: blocks carry their own projections (mLSTM 2x up-proj,
sLSTM 4/3 gated FFN). Sub-quadratic -> runs long_500k."""
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family="ssm", n_layers=24, d_model=1024, n_heads=4,
    n_kv_heads=4, d_ff=0, vocab_size=50304,
    block_pattern=("mlstm", "mlstm", "mlstm", "slstm",
                   "mlstm", "mlstm", "mlstm", "mlstm"),
    sub_quadratic=True,
    source="arXiv:2405.04517 (350M config; unverified tier)")
