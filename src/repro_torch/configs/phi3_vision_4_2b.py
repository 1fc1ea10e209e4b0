"""Phi-3-vision 4.2B — phi3-mini decoder consuming stubbed CLIP patch embeds.

[hf:microsoft/Phi-3-vision-128k-instruct] 32L d_model=3072 32H (kv=32)
d_ff=8192 vocab=32064. The vision tower (CLIP ViT-L/14 + projector input)
is a stub: the batch supplies 576 pre-computed patch embeddings
(``lm_batch`` draws them); the model owns only the projector + decoder.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    arch_type="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    num_patches=576,
    source="hf:microsoft/Phi-3-vision-128k-instruct",
)
