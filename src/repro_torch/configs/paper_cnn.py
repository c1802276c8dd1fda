"""paper-cnn — small inception-style convnet for the faithful vision repro.

The paper evaluates on InceptionV3/ImageNet. This container is CPU-only, so
the faithful reproduction runs the *same algorithm* on a scaled-down
inception-style classifier (conv stem + mixed blocks with parallel towers +
GAP head) over synthetic images. The IG mechanics (path, probe, schedule,
convergence delta) are identical; only the classifier is smaller.
"""
from dataclasses import dataclass, field
from typing import Sequence


@dataclass(frozen=True)
class CnnConfig:
    name: str = "paper-cnn"
    family: str = "vision"
    image_size: int = 32
    channels: int = 3
    num_classes: int = 10
    stem_features: int = 16
    # per mixed-block: (1x1 tower, 3x3 tower, 5x5 tower, pool-proj) features.
    # 4 mixed blocks: deep enough that the prob-vs-alpha path has the paper's
    # rugged, sharply-saturating shape (2 blocks converge too smoothly and
    # the uniform midpoint rule wins by quadrature order — see EXPERIMENTS).
    blocks: Sequence[tuple] = (
        (8, 16, 4, 4),
        (16, 32, 8, 8),
        (24, 48, 12, 12),
        (32, 64, 16, 16),
    )
    param_dtype: str = "float32"
    compute_dtype: str = "float32"


CONFIG = CnnConfig()
