from .encoders import (DGCNN, FeaturePropagation, PointNet, PointNet2MSG,
                       PointNet2SSG, build_encoder)
from .norm import MaskedBatchNorm
from .regressor import PoseRegressor, StochasticPoseRegressor
from .transformer import TransformerEncoder
