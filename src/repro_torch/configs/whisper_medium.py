"""Whisper medium — encoder-decoder ASR transformer (conv frontend stubbed).

[arXiv:2212.04356] 24+24L d_model=1024 16H d_ff=4096 vocab=51865.
The batch supplies pre-computed frame embeddings (the mel+conv frontend
is a stub; ``lm_batch`` draws them); the workload ``seq_len`` is the
*encoder frame* axis, the decoder's target length is the architectural
448 cap.
"""
from repro_torch.configs.base import ModelConfig

DECODER_LEN = 448  # whisper's architectural max target length

CONFIG = ModelConfig(
    name="whisper-medium",
    arch_type="audio",
    num_layers=24,           # decoder layers
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    source="arXiv:2212.04356",
)
