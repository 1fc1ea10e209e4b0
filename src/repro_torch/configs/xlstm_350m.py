"""xLSTM 350M — alternating sLSTM + mLSTM blocks (attention-free).

[arXiv:2405.04517] 24L d_model=1024 4H d_ff=0 vocab=50304.
"""
from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    arch_type="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    xlstm=XLSTMConfig(),
    source="arXiv:2405.04517",
)
