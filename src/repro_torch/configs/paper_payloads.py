"""The paper's own payload models (Table II): EfficientNet/MobileNet sizes,
the port's copy of ``repro.configs.paper_payloads``.

The gossip payload is a parameter tree of a given byte size, so the paper's
CNNs enter as payload specs for the scenario accounting, as the paper uses
them (it measures their transfer, never trains them).
"""
from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class PayloadModel:
    name: str
    code: str
    params_millions: float
    capacity_mb: float
    category: str  # small (0-15MB) | medium (15.1-30) | large (>30)


PAPER_PAYLOADS: Dict[str, PayloadModel] = {
    p.code: p
    for p in [
        PayloadModel("EfficientNet-B0", "b0", 5.3, 21.2, "medium"),
        PayloadModel("EfficientNet-B1", "b1", 7.8, 31.2, "large"),
        PayloadModel("EfficientNet-B2", "b2", 9.2, 36.8, "large"),
        PayloadModel("EfficientNet-B3", "b3", 12.0, 48.0, "large"),
        PayloadModel("MobileNetV2", "v2", 3.5, 14.0, "small"),
        PayloadModel("MobileNetV3 Small (1.0)", "v3s", 2.9, 11.6, "small"),
        PayloadModel("MobileNetV3 Large (1.0)", "v3l", 5.4, 21.6, "medium"),
    ]
}
