"""internvl2-2b — VLM: InternViT (stub) + InternLM2 decoder
[arXiv:2404.16821]. 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92553. Vision encoder + projector are STUBBED: the prompt
supplies (B, 256, 2048) patch embeddings prepended to the token stream."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b", family="vlm", source="arXiv:2404.16821",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8,
    d_ff=8192, vocab_size=92553, num_patches=256,
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
    d_ff=512, vocab_size=512, num_patches=8, remat=False)
