"""granite-34b — dense llama-arch code model [arXiv:2405.04324].
88L d_model=6144 48H (GQA kv=1, i.e. MQA) d_ff=24576 vocab=49152."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b", family="dense", source="arXiv:2405.04324",
    num_layers=88, d_model=6144, num_heads=48, num_kv_heads=1,
    d_ff=24576, vocab_size=49152,
    optimizer="adafactor",   # adamw's f32 moments would not fit one card
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=1,
    d_ff=512, vocab_size=512, remat=False, optimizer="adamw")
