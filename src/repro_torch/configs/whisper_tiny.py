"""whisper-tiny — encoder-decoder audio backbone [arXiv:2212.04356].
4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865. Conv/mel frontend is a
STUB, as in the JAX package: a batch supplies (B, 1500, 384) frame
embeddings as ``enc_embeds``.

long_500k is SKIPPED for this arch (pure full-attention enc-dec; a 512k
decoder sequence has no audio semantics)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny", family="audio", source="arXiv:2212.04356",
    num_layers=4, encoder_layers=4, d_model=384, num_heads=6,
    num_kv_heads=6, d_ff=1536, vocab_size=51865, encoder_seq=1500,
    norm="layernorm", mlp_act="gelu", qkv_bias=True, tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    num_layers=2, encoder_layers=2, d_model=128, num_heads=2,
    num_kv_heads=2, d_ff=256, vocab_size=512, encoder_seq=64, remat=False)
