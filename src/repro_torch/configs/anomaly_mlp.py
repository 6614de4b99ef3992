"""The paper's own model: 3-layer MLP (256,128,64), dropout 0.3.

UNSW-NB15 variant: 49 features, 10 attack classes (+Normal handled as a
class). ROAD variant: CAN-signal window features, binary."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="anomaly-mlp", family="mlp", source="paper §IV-C / Algorithm 1",
    num_layers=3, d_model=256, mlp_hidden=(256, 128, 64),
    num_features=49, num_classes=10, dropout=0.3,
    dtype="float32", remat=False,
)

ROAD_CONFIG = CONFIG.replace(name="anomaly-mlp-road", num_features=32,
                             num_classes=2)

SMOKE = CONFIG.replace(mlp_hidden=(32, 16), num_features=16, num_classes=4)
